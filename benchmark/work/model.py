"""Model FLOPs of a CLIP batch or step, from the configuration: the weight
products (2 multiply-add operations a weight a token, the patch embedding
over the patches and the projections at the one token read), and the
attention's two products, 4 T^2 D a layer, forward. A training step is three
forwards (the backward twice the forward) plus the batch's logits' product."""


def vision_forward(cfg: dict) -> float:
    v = cfg["vision"]
    d, p = v["width"], v["patch_size"]
    t = (v["image_size"] // p) ** 2 + 1
    layers = v["layers"] * (2 * t * 12 * d * d + 4 * t * t * d)
    return 2 * (t - 1) * 3 * p * p * d + layers + 2 * d * v["embed_dim"]


def text_forward(cfg: dict) -> float:
    t = cfg["text"]
    d, n = t["width"], t["context_length"]
    return t["layers"] * (2 * n * 12 * d * d + 4 * n * n * d) + 2 * d * t["embed_dim"]


def zeroshot_batch(cfg: dict, batch: int, labels: int) -> float:
    return batch * vision_forward(cfg) + 2 * batch * labels * cfg["vision"]["embed_dim"]


def train_step(cfg: dict, batch: int) -> float:
    forward = batch * (vision_forward(cfg) + text_forward(cfg))
    return 3 * (forward + 2 * batch * batch * cfg["vision"]["embed_dim"])
