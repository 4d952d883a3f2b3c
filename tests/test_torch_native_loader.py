"""PyTorch port, the C++ JPEG ingest (data/native_loader.py and
native/image_loader.cpp) held byte-equal to the JAX package's binding on
seeded JPEGs and on each fallback; its own build under build/torch_native/.

The tests that need a built library skip where the JAX binding's
`native_available()` is false (no g++ or no libjpeg), as the JAX package's
`needs_native` tests do; the check is made inside a fixture."""

import os
import subprocess
import sys

import numpy as np
import pytest

from construction_clip_tpu.data import native_loader as j_native
from construction_clip_tpu.data import pipeline as j_pipeline
from construction_clip_tpu_torch.data import native_loader, pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_native():
    """Skips where the JAX binding has no library, as its needs_native does."""
    if not j_native.native_available():
        pytest.skip("native lib unavailable (no g++/libjpeg)")
    assert native_loader.native_available()


def _images(root):
    """{name: path}: seeded JPEGs (a 1024x768 one that libjpeg decodes
    prescaled in the DCT, a small, a portrait, a grey and a truncated one), a PNG,
    and PNG bytes under a .jpg name (a decode error: rc != 0)."""
    from PIL import Image

    gen = np.random.default_rng(17)
    yy, xx = np.mgrid[0:768, 0:1024]
    smooth = np.stack([xx % 256, yy % 256, (xx + yy) % 256], axis=-1).astype(np.uint8)
    noisy = np.clip(smooth + gen.normal(0, 12, smooth.shape), 0, 255).astype(np.uint8)
    paths = {}

    def save(name, arr, **kw):
        paths[name] = str(root / name)
        Image.fromarray(arr).save(paths[name], **kw)

    save("large.jpg", noisy, quality=90)
    save("small.jpeg", (gen.random((40, 50, 3)) * 255).astype(np.uint8), quality=95)
    save("portrait.jpg", noisy[:700, :300], quality=80)
    save("grey.jpg", noisy[:300, :500, 0])
    save("plain.png", noisy[:120, :90])
    save("png_bytes.jpg", noisy[:64, :80], format="PNG")
    data = open(paths["large.jpg"], "rb").read()
    paths["truncated.jpg"] = str(root / "truncated.jpg")
    open(paths["truncated.jpg"], "wb").write(data[: len(data) // 2])
    return paths


@pytest.mark.parametrize("size", [256, 224])
def test_decodes_are_byte_equal_to_the_jax_binding(jax_native, tmp_path, size):
    for name, path in _images(tmp_path).items():
        got = native_loader.load_image_native(path, size)
        assert got.shape == (size, size, 3) and got.dtype == np.uint8, name
        np.testing.assert_array_equal(got, j_native.load_image_native(path, size),
                                      err_msg=name)
    hook = native_loader.make_native_loader(size)
    np.testing.assert_array_equal(hook(str(tmp_path / "large.jpg")),
                                  j_native.make_native_loader(size)(str(tmp_path / "large.jpg")))


def test_the_fallbacks_are_the_ports_pil_path(jax_native, tmp_path):
    """A PNG, and PNG bytes under a .jpg name (libjpeg refuses them), come from
    host_shape_unify(default_load_image(...)), the port's and the JAX one alike."""
    paths = _images(tmp_path)
    for name in ("plain.png", "png_bytes.jpg"):
        want = pipeline.host_shape_unify(pipeline.default_load_image(paths[name]), 224)
        np.testing.assert_array_equal(native_loader.load_image_native(paths[name], 224), want)
        np.testing.assert_array_equal(
            want, j_pipeline.host_shape_unify(j_pipeline.default_load_image(paths[name]), 224))


def test_no_native_gives_the_pil_path(tmp_path, monkeypatch):
    monkeypatch.setenv("CCTPU_NO_NATIVE", "1")
    monkeypatch.setattr(native_loader, "_lib", None)
    paths = _images(tmp_path)
    assert not native_loader.native_available()
    for name in ("large.jpg", "grey.jpg"):
        want = pipeline.host_shape_unify(pipeline.default_load_image(paths[name]), 256)
        np.testing.assert_array_equal(native_loader.load_image_native(paths[name], 256), want)


def test_the_build_goes_to_its_own_directory_and_never_to_native(jax_native, tmp_path,
                                                                   monkeypatch):
    """Three processes build at once into one empty directory: one library
    under the source's hash, no temporary file left, nothing written to
    native/; the library loads and decodes as the JAX binding does."""
    native_dir = os.path.join(REPO, "native")
    before = sorted(os.listdir(native_dir))
    build = tmp_path / "torch_native"
    code = ("import sys; from pathlib import Path; "
            "from construction_clip_tpu_torch.data import native_loader as n; "
            "n.BUILD_DIR = Path(sys.argv[1]); n._build(n.library_path())")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)], cwd=REPO)
             for _ in range(3)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0, 0]
    monkeypatch.setattr(native_loader, "BUILD_DIR", build)
    so = native_loader.library_path()
    assert sorted(os.listdir(build)) == [so.name]
    assert so.name.startswith("libcct_image_") and sorted(os.listdir(native_dir)) == before
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_build_failed", False)
    assert native_loader.native_available()
    path = _images(tmp_path)["large.jpg"]
    np.testing.assert_array_equal(native_loader.load_image_native(path, 256),
                                  j_native.load_image_native(path, 256))


def test_a_failed_build_is_remembered_and_the_calls_take_pil(tmp_path, monkeypatch):
    """As the JAX binding: the library calls move to PIL quietly, and
    native_available() says false."""
    monkeypatch.delenv("CCTPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_build_failed", False)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(native_loader, "CXX_FLAGS", ("-O3", "--no-such-flag"))
    path = _images(tmp_path)["small.jpeg"]
    want = pipeline.host_shape_unify(pipeline.default_load_image(path), 64)
    np.testing.assert_array_equal(native_loader.load_image_native(path, 64), want)
    assert native_loader._build_failed and not native_loader.native_available()
    assert not (tmp_path / "b").exists() or os.listdir(tmp_path / "b") == []


def test_the_cpp_source_is_the_jax_packages():
    """The port's copy of native/image_loader.cpp, from its first #include on
    (its header comment names the port's binding)."""
    port = open(native_loader.SOURCE, encoding="utf-8").read()
    orig = open(os.path.join(REPO, "native", "image_loader.cpp"), encoding="utf-8").read()
    assert port[port.index("\n#include"):] == orig[orig.index("\n#include"):]
