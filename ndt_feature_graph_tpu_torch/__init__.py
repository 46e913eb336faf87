"""ndt_feature_graph_tpu_torch — PyTorch/CUDA port of ndt_feature_graph_tpu.

The JAX package `ndt_feature_graph_tpu` is the reference; this package
mirrors its layout (core/, io/, ops/, features/, fusion/, graph/,
models/, parallel/) and
function names so each port sits beside its counterpart.  It imports
torch, never jax and nothing of the JAX package: the parameter
dataclasses (config.py) and the numpy trajectory tools (io/tum.py) are
its own copies.  The one TPU kernel of the online graph-SLAM path
(`ops/pallas_kernels.py:pair_fgh_reduce`) is a hand-written CUDA kernel
for Hopper here (`csrc/pair_fgh.cu`, bound in `ops/cuda_kernels.py`).

The reference computes in full float32, so TF32 matmuls and
convolutions are switched off explicitly: the descriptor's one-hot
contractions and the detector's smoothing are matmuls.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from ndt_feature_graph_tpu_torch.config import (  # noqa: E402
    FuserParams,
    GraphParams,
    MatcherParams,
    MotionParams,
    NDTMapParams,
)


def resolve_device(device=None) -> torch.device:
    """The device a loader or constructor puts its tensors on: the one
    asked for, else the CUDA card.  Without a card `device=None` raises
    — the port never lands on the CPU silently; pass device="cpu" to
    run there."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            'device="cpu" to run on the CPU'
        )
    return torch.device("cuda")
