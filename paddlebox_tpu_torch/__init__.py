"""paddlebox_tpu_torch — the PyTorch/CUDA port of paddlebox_tpu.

The module layout mirrors ``paddlebox_tpu`` so each counterpart is found
under the same name. The package imports torch and numpy only: never jax,
and nothing of ``paddlebox_tpu``. Entry points (``Trainer``,
``PassWorkingSet.begin_pass``) run on the CUDA card unless the caller
passes ``device="cpu"``; with no card and no explicit CPU request they
raise (see :mod:`paddlebox_tpu_torch.device`).

The four hand-written Hopper kernels of the training step
(``gather_pool``, ``scatter_accumulate``, ``binned_merge_acc``,
``merge_update``) live under ``csrc/`` and are built with nvcc at first
use into ``_build/`` (:mod:`.ops.kernels`). Persistence (``utils/``,
``embedding/store.py``, ``fleet/``) writes the JAX package's file
formats, so checkpoints and models move between the two packages.
"""

__version__ = "0.1.0"
