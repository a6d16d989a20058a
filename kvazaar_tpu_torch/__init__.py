"""kvazaar_tpu_torch — the fixed-grid HEVC encode paths in PyTorch + CUDA.

A port of the fixed-grid all-intra and low-delay P slices of
``kvazaar_tpu`` (the JAX reference package, kept beside this one):
intra mode search, motion search and compensation, the wavefront
reconstruction (a hand-written CUDA kernel on the card,
``csrc/wavefront.cu``), deblocking and per-frame SSE run as tensor code
on the encoder's device; CABAC and the NAL framing run on the host.
The host modules (config, constants, bitstream writers, YUV I/O) are
the port's own copies of the reference package's jax-free modules: the
port imports nothing of ``kvazaar_tpu``.

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


from kvazaar_tpu_torch.config import Config  # noqa: E402,F401
