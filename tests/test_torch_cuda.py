"""The CUDA kernel entries of ops/cuda_kernels.py against their plain
PyTorch twins on the card.  Marked `cuda`: they skip without a CUDA
card.  The file imports no JAX, so it also runs where JAX is not
installed (skip the JAX-importing conftest there):

    python3 -m pytest --noconftest tests/test_torch_cuda.py

Tolerances as tests/test_pallas_kernels.py (f rtol 1e-4; g, H rtol
2e-3): the kernel sums in another order than the plain version.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu_torch.ops import cuda_kernels

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 256, 257, 6400, 100_000])
def test_pair_fgh_reduce_matches_plain(cuda_device, n):
    """Sizes around the 256-thread block and many-block reductions."""
    args = chip_smoke.random_pairs(n, cuda_device, seed=n)
    before = cuda_kernels.LAUNCHES["pair_fgh_reduce"]
    got = cuda_kernels.pair_fgh_reduce(*args, 1.0, 0.05)
    again = cuda_kernels.pair_fgh_reduce(*args, 1.0, 0.05)
    ref = cuda_kernels.pair_fgh_reduce_reference(*args, 1.0, 0.05)
    chip_smoke.compare(f"pair_fgh_reduce n={n}", got, ref)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert cuda_kernels.LAUNCHES["pair_fgh_reduce"] == before + 2


@pytest.mark.cuda
def test_pair_fgh_reduce_broadcasts_like_pallas(cuda_device):
    """(N, K) pairs against (N, 1) source terms, as the D2D window term
    hands them to the Pallas kernel."""
    rng = np.random.default_rng(3)
    n, k = 64, 25
    L = 0.2 * rng.standard_normal((n, k, 2, 2))
    Lc = 0.2 * rng.standard_normal((n, 1, 2, 2))
    t = lambda x: torch.as_tensor(x, dtype=torch.float32,  # noqa: E731
                                  device=cuda_device)
    args = (t(0.5 * rng.standard_normal((n, k, 2))),
            t(L @ L.transpose(0, 1, 3, 2) + 0.05 * np.eye(2)),
            t(3.0 * rng.standard_normal((n, 1, 2))),
            t(Lc @ Lc.transpose(0, 1, 3, 2) + 0.02 * np.eye(2)),
            torch.as_tensor(rng.random((n, k)) < 0.7, device=cuda_device))
    chip_smoke.compare(
        "pair_fgh_reduce broadcast",
        cuda_kernels.pair_fgh_reduce(*args, 1.0, 0.05),
        cuda_kernels.pair_fgh_reduce_reference(*args, 1.0, 0.05))


@pytest.mark.cuda
def test_kernels_match_plain_at_main_path_shapes(cuda_device):
    """Both entries on a canonical fuser state (N=256 x K=25, 64 feature
    pairs, all masked, windows across the grid edge): chip_smoke.py's
    phase 3."""
    with np.load(chip_smoke.FIXTURE) as f:
        fx = dict(f)
    sp = chip_smoke.canonical_slam_params(float(fx["split_m"]),
                                          int(fx["max_nodes"]))
    errs, times = chip_smoke.kernel_checks(sp, fx, cuda_device)
    assert set(errs) == set(times) == {"fgh_dense_flat", "pair_fgh_reduce"}


def _small_bank(dev):
    """Four canonical nodes: fusers initialized on fixture scans 0, 50,
    100 and 150 in their node frames, frozen at the ground-truth poses,
    and the relative poses of all ordered pairs."""
    from ndt_feature_graph_tpu_torch.core import se2
    from ndt_feature_graph_tpu_torch.fusion import fuser
    from ndt_feature_graph_tpu_torch.graph import node as node_mod
    from ndt_feature_graph_tpu_torch.io import dataset

    with np.load(chip_smoke.FIXTURE) as f:
        fx = dict(f)
    sp = chip_smoke.canonical_slam_params(float(fx["split_m"]),
                                          int(fx["max_nodes"]))
    p = sp.fuser
    t = lambda x, dt=torch.float32: torch.as_tensor(  # noqa: E731
        x, dtype=dt, device=dev)
    scans = (0, 50, 100, 150)
    fmap = node_mod.empty_feature_map(16, 48, dev)
    nodes = []
    for s in scans:
        pts, mask = dataset.scan_to_points(t(fx["ranges"][s]),
                                           t(fx["hit"][s], torch.bool))
        st = fuser.initialize(p, torch.zeros(3, device=dev),
                              torch.zeros(3, device=dev), pts, mask)
        nodes.append(node_mod.freeze_node(p, t(fx["gt"][s]), st, fmap))
    bank = node_mod.stack_nodes(nodes)
    pairs = np.asarray([(i, j) for i in range(4) for j in range(4) if i != j])
    gt = t(fx["gt"][list(scans)])
    T0 = se2.sub(gt[pairs[:, 0]], gt[pairs[:, 1]]).cpu().numpy()
    return sp, bank, pairs, T0


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 12, 300])
def test_fgh_dense_flat_batch_matches_plain(cuda_device, lanes):
    """The batch entry against its plain twin on a canonical node bank:
    pair lanes plus an all-masked lane, a lane on the bank's last node
    and one whose windows cross the grid edge; two calls give identical
    bits (chip_smoke.py's phase 3b)."""
    from ndt_feature_graph_tpu_torch.graph import links

    sp, bank, pairs, T0 = _small_bank(cuda_device)
    idx = np.resize(np.arange(len(pairs)), lanes)
    before = cuda_kernels.LAUNCHES["fgh_dense_flat_batch"]
    err, _ = chip_smoke.batch_kernel_checks(
        bank, pairs[idx], T0[idx], links.source_cell_budget(bank), sp,
        cuda_device, times=False)
    assert np.isfinite(err)
    assert cuda_kernels.LAUNCHES["fgh_dense_flat_batch"] == before + 2

