"""Jax-free entry points to cdlrm_tpu's shared configuration and host layer.

The port reuses ``cdlrm_tpu.config.Config``, ``cdlrm_tpu.cli.build_dataset``
and ``cdlrm_tpu.cache.host_cache`` as they are. Importing them loads no jax,
but three of their methods import a jax module lazily, each for a numpy
helper only:

- ``Config.finalize`` imports ``cdlrm_tpu.models.dlrm`` and
  ``cdlrm_tpu.models.tricks`` (config.py:367-368) for
  ``derive_top_mlp_input_dim`` and ``md_solver``;
- ``HostCacheController.probe_wire`` and ``probe_dedup`` import
  ``cdlrm_tpu.train.step`` (host_cache.py:383, :440) for ``pack_slots``,
  ``wire_bytes`` and ``wire_width``.

Inside :func:`jax_free_host` those three import names resolve to this
package's counterparts, which define the same helpers with the same
arithmetic; on exit the previous ``sys.modules`` entries are restored.
"""

from __future__ import annotations

import contextlib
import importlib
import sys
import threading
from typing import Iterator, Optional

import numpy as np

from cdlrm_tpu.config import Config

_STAND_INS = {
    "cdlrm_tpu.models.dlrm": "cdlrm_tpu_torch.models.dlrm",
    "cdlrm_tpu.models.tricks": "cdlrm_tpu_torch.models.tricks",
    "cdlrm_tpu.train.step": "cdlrm_tpu_torch.train.step",
}
# one holder at a time: nested or concurrent users (the eval producer thread
# probes while the main thread may finalize another config) must not
# restore each other's stand-ins
_LOCK = threading.RLock()


@contextlib.contextmanager
def jax_free_host() -> Iterator[None]:
    """Run shared host-layer code with its lazy jax imports pointed at this
    package's jax-free modules (module docstring)."""
    with _LOCK:
        saved = {name: sys.modules.get(name) for name in _STAND_INS}
        try:
            for name, sub in _STAND_INS.items():
                sys.modules[name] = importlib.import_module(sub)
            yield
        finally:
            for name, mod in saved.items():
                if mod is None:
                    sys.modules.pop(name, None)
                else:
                    sys.modules[name] = mod


def finalize(
    cfg: Config, ln_emb: Optional[np.ndarray] = None, m_den: Optional[int] = None
) -> Config:
    """``cfg.finalize(ln_emb, m_den)`` without importing jax."""
    with jax_free_host():
        return cfg.finalize(ln_emb=ln_emb, m_den=m_den)


def build_dataset(cfg: Config):
    """``cdlrm_tpu.cli.build_dataset`` without importing jax: returns
    (train_ds, test_ds, cfg) with the config finalized."""
    from cdlrm_tpu.cli import build_dataset as shared_build_dataset

    with jax_free_host():
        return shared_build_dataset(cfg)
