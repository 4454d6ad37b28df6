"""nmf_tpu — a non-negative matrix factorization framework for GPUs.

A from-scratch JAX/XLA implementation of the full capability surface
of JuliaStats/NMF.jl (reference mounted at /root/reference): six solvers
(multiplicative updates for MSE and KL, projected ALS, ALS projected
gradient, Fast-HALS coordinate descent, greedy CD, SPA), the
NNDSVD/NNDSVDa/NNDSVDar/random/SPA/custom initializer family backed by a
randomized SVD, multi-start replicates, per-factor solving and L1/L2
regularization — all exposed through the ``nnmf`` front door returning a
``Result(W, H, niters, converged, objvalue)``.

Every solver is a pure-function updater over a pytree state driven by one
jitted ``lax.while_loop`` skeleton; the factors and data shard over a
("rows", "cols") device mesh (see ``nmf_tpu.parallel``), with all
collectives inserted by GSPMD.
"""

from .models.alspgrad import ALSPGrad, alspgrad_updateh, alspgrad_updatew
from .models.checkpoint import solve_checkpointed
from .models.common import Result, Trace, nmf_checksize, solve, stop_condition
from .models.coorddesc import CoordinateDescent
from .models.greedycd import GreedyCD
from .models.interface import nnmf, solve_replicates
from .models.multupd import MultUpdate
from .models.projals import ProjectedALS
from .models.spa import SPA, separable_data, spa
from .init.initialization import nndsvd, randinit
from .ops.fnnls import fnnls, nnls_gram
from .ops.objectives import gkldiv, kl_objective, mse_objective, sqL2dist
from .ops.linalg import pdsolve, pdrsolve
from .ops.rsvd import rsvd
from .utils.precompile import warmup
from .utils.numeric import (
    adddiag,
    normalize1,
    normalize1_cols,
    posneg,
    printf_mat,
    projectnn,
)

__version__ = "0.1.0"

__all__ = [
    "nnmf",
    "Result",
    "Trace",
    "solve",
    "solve_checkpointed",
    "solve_replicates",
    "stop_condition",
    "nmf_checksize",
    "MultUpdate",
    "ProjectedALS",
    "ALSPGrad",
    "CoordinateDescent",
    "GreedyCD",
    "SPA",
    "alspgrad_updateh",
    "alspgrad_updatew",
    "spa",
    "separable_data",
    "randinit",
    "nndsvd",
    "rsvd",
    "fnnls",
    "nnls_gram",
    "sqL2dist",
    "gkldiv",
    "mse_objective",
    "kl_objective",
    "pdsolve",
    "pdrsolve",
    "adddiag",
    "normalize1",
    "normalize1_cols",
    "projectnn",
    "posneg",
    "printf_mat",
    "warmup",
]
