"""PyTorch/CUDA port of the corrosion-tpu gossip simulator.

The JAX package ``corrosion_tpu`` stays the reference; this package
mirrors its layout (``corrosion_tpu_torch/sim/packed.py`` is the
counterpart of ``corrosion_tpu/sim/packed.py``) and reproduces its
results bit for bit.  It imports ``torch`` and nothing of JAX or of the
JAX package.

Entry points take a ``device`` argument that defaults to ``"cuda"``;
without a card they raise unless the caller passes ``device="cpu"``
(`device.resolve_device`).  Hot device functions run hand-written CUDA
kernels (`kernels/`) on CUDA tensors and their plain torch versions on
CPU tensors.
"""
