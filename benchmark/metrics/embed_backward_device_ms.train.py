"""The median over the traced steps of the device time of the kernels
launched inside the program's `embed_backward` span (`ops/embedding.py`'s
`embedding_backward`: the text tower's token-embedding backward, launched on
autograd's device thread inside `backward`) (work/spans.py). A program
without the span reads None."""

from work import spans


def read(record):
    return spans.median(record, "embed_backward", "device_ms")
