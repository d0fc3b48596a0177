"""cdlrm_tpu_torch: the PyTorch + CUDA port of cdlrm_tpu for NVIDIA Hopper.

The package mirrors cdlrm_tpu's layout (``models/``, ``ops/``, ``train/``,
``cli.py``) so each module's counterpart is easy to find, and reuses
cdlrm_tpu's jax-free host layer (Config, cache/, data/, ops/native.py,
utils/) instead of copying it: both packages probe, pack and gather the same
bytes on the host. Importing this package never imports jax.

Ported so far, on one device: cached training (SGD; the plain wire and the
packed and unpacked dedup wires; scan blocks with the block-coalesced
update) and serving, and the full-table trainer, with hand-written CUDA
kernels for the row gather and its backward, the row set and the row add
(``csrc/row_ops.cu``). ROADMAP.md lists what remains.
"""

__version__ = "0.1.0"
