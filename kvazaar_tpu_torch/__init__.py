"""kvazaar_tpu_torch — the all-intra HEVC encode path in PyTorch + CUDA.

A port of the fixed-grid all-intra slice of ``kvazaar_tpu`` (the JAX
reference package, kept beside this one): intra mode search, the
wavefront reconstruction (a hand-written CUDA kernel on the card,
``csrc/wavefront.cu``), deblocking and per-frame SSE run as tensor code
on the encoder's device; CABAC and the NAL framing run on the host
through the reference package's jax-free bitstream modules.

Every module keeps the name and place of its counterpart in
``kvazaar_tpu``.  The device is always an explicit argument
(``IntraFrameEncoder(cfg, device=...)``, ``Encoder(cfg, device=...)``):
nothing here picks a device on its own.
"""

__version__ = "0.1.0"


def require_cuda():
    """The first CUDA device as a ``torch.device``; raises RuntimeError
    when this process sees no card."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("kvazaar_tpu_torch: no CUDA device is "
                           "available in this process")
    return torch.device("cuda", 0)


# The configuration object is shared with the JAX package, used as is
# (kvazaar_tpu.config imports no jax).
from kvazaar_tpu.config import Config  # noqa: E402,F401
