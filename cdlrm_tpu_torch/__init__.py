"""cdlrm_tpu_torch: the PyTorch + CUDA port of cdlrm_tpu for NVIDIA Hopper.

The package mirrors cdlrm_tpu's layout (``models/``, ``ops/``, ``train/``,
``cache/``, ``data/``, ``utils/``, ``config.py``, ``cli.py``) so each
module's counterpart is easy to find. It imports torch, never jax and
nothing of cdlrm_tpu: the host layer (Config, cache/, data/, ops/native.py
with csrc/host_ops.cpp, train/pipeline.py, utils/) is its own copy, held
equal to cdlrm_tpu's by tests/test_torch_host.py, so both packages probe,
pack and gather the same bytes on the host.

On one device it trains the cached path (SGD and AdaGrad; the plain wire and
the packed and unpacked dedup wires; scan blocks with the block-coalesced
update) and the full-table path, saves and loads checkpoints in cdlrm_tpu's
format, and serves, with hand-written CUDA kernels for the row gather and
its backward, the row set and the row add (``csrc/row_ops.cu``). ROADMAP.md
lists what remains.
"""

__version__ = "0.1.0"
