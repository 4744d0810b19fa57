"""Static-analysis subsystem of the port (mirrors ``repro.analysis``):
contract auditors over a recorded trace, the Hopper kernel budget, and the
lint gate.

Three auditors, one CLI (``python -m repro_torch.analysis``):

  * :mod:`repro_torch.analysis.contracts` — invariant checks over the
    recorded trace of one call (in-place state, dtype bans, f32
    accumulation, collective order, trust ratios gathered whole,
    knob-invariant op sequences), registered next to the code they
    protect and evaluated over a config matrix by
    :mod:`repro_torch.analysis.runner`.
  * :mod:`repro_torch.analysis.kernel_budget` — per kernel instance the
    port builds, its threads, shared memory, register cap and resident
    CTAs per SM on an H100, held on the card to ptxas's report and the
    CUDA occupancy API; plus grid alignment of the partition plans.
  * :mod:`repro_torch.analysis.lint` — AST rules encoding the repo's
    conventions (no bare assert, no host sync in the step's modules, no
    env read in a function body, no duplicate import) with a burn-down
    baseline.

This ``__init__`` stays import-light on purpose: production modules
(kernels/ops.py, train/loop.py, sharding/rules.py, serve/kvcache.py)
import ``contracts`` / ``mutations`` at module level, so nothing here may
pull in torch.  ``runner`` / ``kernel_budget`` / ``lint`` are imported
explicitly by the CLI and the tests.
"""
from repro_torch.analysis import contracts, dtypes, mutations
from repro_torch.analysis.dtypes import DTYPE_BYTES, dtype_bytes, nbytes

__all__ = ["contracts", "dtypes", "mutations", "DTYPE_BYTES", "dtype_bytes",
           "nbytes"]
