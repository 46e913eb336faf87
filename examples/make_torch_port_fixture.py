"""Write the canonical fixtures the PyTorch port's chip smoke test reads.

The port runs on a machine without JAX, so this script runs the JAX
reference on the CPU once, at the canonical operating point
(`bench.canonical_params()`, `bench.make_sequence()`: 0.5 m cells on a
100x100 m map, 30 m range, 720 beams, the 200-scan corridor, node split
every 2 m, max_nodes=64), after the `bench.verify_cell_budget` gate, and
saves what the port needs to be held against it:

  ranges, hit, odom, gt          the sequence
  ransac_u (T-1, M, 2)           the RANSAC draws JAX used, per scan
  traj, node_T, edge_rel         the JAX trajectory and graph
  max_cells                      the largest local-NDT cell count seen
  params_repr                    repr() of the SLAMParams the reference ran

    JAX_PLATFORMS=cpu python examples/make_torch_port_fixture.py \
        [--out ndt_feature_graph_tpu_torch/data/canonical_200.npz]

With --lc it writes the loop-closure record instead
(ndt_feature_graph_tpu_torch/data/canonical_lc.npz; it reuses the
sequence of canonical_200.npz, which it checks): on the same corridor,

  off_*   the offline graph of bench.py's bench_offline (a node every
          0.25 m): pipeline.run_slam + optimize_offline, with the scan
          and pair draws, node poses before and after, the proposed
          LinkSet and the final keep mask, each node's scan index; the
          RANSAC poses before refinement (off_ransac_T) and the refined
          poses from RANSAC poses moved by 1e-6 (off_link_T_eps: the
          refinement's own spread); the frozen graph itself (off_bank.*,
          the stacked node bank flattened by field, and off_edge_*, the
          odometry edges), so that the port can run optimize_offline on
          the reference's own graph; and off_alt_*, the optimized poses
          and keep mask of the same run with the odometry offset by 1e-6
          (the reference's own spread);
  on_*    bench.py's bench_online_lc setting (a node every 2 m, online
          loop closure, valid_min_idx_dist=1, candidates within 20 m):
          run_sequence_chunked(chunk=64), with the scan and pair draws
          (and the splits whose proposals took them), the trajectory,
          node poses and loop links.

`replay_ransac_draws` is the replay of the JAX key chain, shared with
the port's parity tests; `recording_slam_class` logs the keys a JAX run
really takes, against which the replay is checked.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import NamedTuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "ndt_feature_graph_tpu_torch", "data")
DEFAULT_OUT = os.path.join(DATA, "canonical_200.npz")
LC_OUT = os.path.join(DATA, "canonical_lc.npz")
SPLIT_M = 2.0
MAX_NODES = 64
SEED = 0
ALT_ODOM = 1e-6     # odometry offset (m, rad) of the second offline record


class Replay(NamedTuple):
    """The replayed key chain of one JAX SLAM run."""

    scan_u: np.ndarray      # (T-1, M, 2) RANSAC draws, one row per scan
    fuser_keys: np.ndarray  # (T-1, 2) the fuser key after each scan
    pair_u: list            # (P, M, 2) draws of each link proposal
    pair_keys: list         # the SLAM subkey of each link proposal
    key: np.ndarray         # (2,) the SLAM key at the end


def _pair_uniforms(key, p, m_hyp):
    """The draws of a P-pair link proposal under `key`: split into P
    pair keys, each drawing from the first half of its own split (as
    links.compute_links_batch -> ransac.match_sets)."""
    import jax

    keys = jax.random.split(key, p)
    return np.asarray(jax.vmap(
        lambda k: jax.random.uniform(jax.random.split(k)[0], (m_hyp, 2))
    )(keys), np.float32)


def replay_ransac_draws(seed, odom, sparams, lc_splits=(), pair_counts=()):
    """Replay the JAX key chain of `NDTFeatureGraphSLAM(sparams, seed)`
    driven over `odom` (T, 3), scan 0 consumed by initialize.

    The SLAM key is split once at initialize (the fuser's key) and once
    per node split (the new fuser's key); each scan splits the fuser key
    and draws its (M, 2) RANSAC uniforms from the first half of a split
    of the scan key.  Where the splits fall depends only on odometry
    (`split_schedule`).  An online loop-closure proposal after the
    split of ordinal n (n in `lc_splits`) then takes the next SLAM key
    for its online_lc_max_candidates pairs; each entry P of
    `pair_counts` is one later offline proposal chunk of P pairs
    (`offline_pair_counts`)."""
    import jax

    from ndt_feature_graph_tpu_torch.fusion.scan_driver import (
        split_schedule,
    )

    p, gp = sparams.fuser, sparams.graph
    m_hyp = p.features.ransac_hypotheses
    split, _, _, _, _ = split_schedule(
        np.asarray(odom)[1:], 0.0, 0, gp.new_node_transl_dist,
        gp.max_nodes, p.feature_map_update_incr,
    )
    key = jax.random.PRNGKey(seed)
    key, fkey = jax.random.split(key)
    draws, keys, pair_u, pair_keys = [], [], [], []

    def proposal(key, n_pairs):
        key, sub = jax.random.split(key)
        pair_keys.append(np.asarray(sub))
        pair_u.append(_pair_uniforms(sub, n_pairs, m_hyp))
        return key

    n_split = 0
    for s in split:
        fkey, sub = jax.random.split(fkey)
        ki, _ = jax.random.split(sub)
        draws.append(np.asarray(jax.random.uniform(ki, (m_hyp, 2))))
        if s:
            key, fkey = jax.random.split(key)
            if n_split in lc_splits:
                key = proposal(key, gp.online_lc_max_candidates)
            n_split += 1
        keys.append(np.asarray(fkey))
    for n_pairs in pair_counts:
        key = proposal(key, n_pairs)
    return Replay(np.stack(draws).astype(np.float32), np.stack(keys),
                  pair_u, pair_keys, np.asarray(key))


def offline_pair_counts(n_pairs: int, link_batch_size: int):
    """Pairs per proposal chunk of slam._propose_links."""
    b = link_batch_size
    if b <= 0 or n_pairs <= b:
        return [n_pairs]
    return [b] * (-(-n_pairs // b))


def recording_slam_class():
    """A JAX NDTFeatureGraphSLAM subclass that logs (calling method, key)
    in `key_log` for every key its _split_key hands out."""
    from ndt_feature_graph_tpu.graph.slam import NDTFeatureGraphSLAM

    class RecordingSLAM(NDTFeatureGraphSLAM):
        def __init__(self, params, seed=0):
            super().__init__(params, seed=seed)
            self.key_log = []

        def _split_key(self):
            sub = super()._split_key()
            self.key_log.append((sys._getframe(1).f_code.co_name,
                                 np.asarray(sub)))
            return sub

    return RecordingSLAM


def lc_splits_of(key_log):
    """Ordinals of the node splits after which an online loop-closure
    proposal took a key, from a recording_slam key log."""
    out, n = [], -1
    for name, _ in key_log:
        if name == "_finish_split":
            n += 1
        elif name == "_try_online_loop_closure":
            out.append(n)
    return out


def flatten_tree(tree, prefix):
    """A NamedTuple tree of arrays as {"prefix.field.sub": numpy array}
    (interop.tree_from_flat reads it back)."""
    if hasattr(tree, "_fields"):
        out = {}
        for name in tree._fields:
            out.update(flatten_tree(getattr(tree, name), f"{prefix}.{name}"))
        return out
    return {prefix: np.asarray(tree)}


def record_offline(slam, verbose=False):
    """Run the JAX slam.optimize_offline, recording the proposed LinkSet
    and the keep mask of every fixpoint solve (the last is the final
    kept-link set).  Returns (optimized node poses, LinkSet as numpy,
    keep masks)."""
    import jax

    keeps, sets = [], []
    edges_from = slam._edges_from

    def recorded(link_set, keep, node_T):
        sets.append(link_set)
        keeps.append(np.asarray(keep))
        return edges_from(link_set, keep, node_T)

    slam._edges_from = recorded
    out = np.asarray(slam.optimize_offline(verbose=verbose))
    del slam._edges_from
    return out, jax.tree.map(np.asarray, sets[0]), keeps


def make_lc_fixture(out, seq, fp):
    """The loop-closure record (see the module docstring)."""
    import jax
    import jax.numpy as jnp

    from ndt_feature_graph_tpu import pipeline as jpipe
    from ndt_feature_graph_tpu.config import GraphParams, SLAMParams
    from ndt_feature_graph_tpu.graph import links as jlinks
    from ndt_feature_graph_tpu.graph import node as jnode
    from ndt_feature_graph_tpu_torch.fusion.scan_driver import (
        split_schedule,
    )
    from ndt_feature_graph_tpu_torch.pipeline import gate_scans
    from chip_smoke import LC_GRAPH, OFFLINE_SPLIT_M

    seqn = jax.tree.map(np.asarray, seq)
    with np.load(DEFAULT_OUT) as ref:
        for k in ("ranges", "hit", "odom", "gt"):
            if not np.array_equal(ref[k], getattr(seqn, k)):
                raise SystemExit(f"{DEFAULT_OUT} holds another {k}")

    sp_off = SLAMParams(fuser=fp, graph=GraphParams(
        new_node_transl_dist=OFFLINE_SPLIT_M, max_nodes=MAX_NODES))
    off, stats = jpipe.run_slam(sp_off, seq, seed=SEED)
    before = np.stack(off.node_T)
    bank = flatten_tree(jax.tree.map(np.asarray,
                                     jnode.stack_nodes(off.nodes)), "off_bank")
    key_before = np.asarray(off._key)
    pairs = off.candidate_pairs()
    n_pairs = int(np.asarray(pairs[2]).sum())
    after, links, keeps = record_offline(off, verbose=True)
    keep_idx, keep_acc = gate_scans(seqn.odom, sp_off.min_incr_dist,
                                    sp_off.min_incr_rot)
    odom_g = np.concatenate([np.zeros((1, 3), np.float32),
                             np.stack(keep_acc)])
    rep_off = replay_ransac_draws(
        SEED, odom_g, sp_off,
        pair_counts=offline_pair_counts(n_pairs, sp_off.graph.link_batch_size))
    if not np.array_equal(
            replay_ransac_draws(SEED, odom_g, sp_off).key, key_before):
        raise SystemExit("offline: the replayed SLAM key is not JAX's")
    # The proposal's stages: the RANSAC poses, and the refinement's own
    # spread (the refined poses from RANSAC poses moved by 1e-6).
    if len(rep_off.pair_keys) != 1:
        raise SystemExit("offline: the record expects one proposal chunk")
    stacked = jnode.stack_nodes(off.nodes)
    ransac = jlinks.compute_links_batch(
        fp.features, fp.ndt.resolution, stacked, *pairs,
        jnp.asarray(rep_off.pair_keys[0]))
    budget = jlinks.source_cell_budget(stacked)
    refine = lambda ls: jlinks.refine_links_d2d(  # noqa: E731
        fp.ndt, fp.matcher, stacked, ls, src_budget=budget)
    if not np.array_equal(np.asarray(refine(ransac).T), links.T):
        raise SystemExit("offline: the replayed proposal is not JAX's")
    link_T_eps = refine(ransac._replace(T=ransac.T + ALT_ODOM)).T
    gp = sp_off.graph
    split = split_schedule(odom_g[1:], 0.0, 0, gp.new_node_transl_dist,
                           gp.max_nodes, fp.feature_map_update_incr)[0]
    node_scan = [0] + [keep_idx[i] for i in np.flatnonzero(split)]

    # The same offline problem with the odometry moved by 1 um: on this
    # corridor the reference's own solve lands centimetres away from the
    # record (a second basin), the spread any reordered float32 sum sees.
    alt, _ = jpipe.run_slam(sp_off, seq._replace(odom=seq.odom + ALT_ODOM),
                            seed=SEED)
    alt_after, _, alt_keeps = record_offline(alt)

    sp_on = SLAMParams(fuser=fp, graph=GraphParams(
        new_node_transl_dist=SPLIT_M, max_nodes=MAX_NODES, **LC_GRAPH))
    on = recording_slam_class()(sp_on, seed=SEED)
    on.initialize(seq.gt[0], jnp.zeros(3), seq.ranges[0], seq.hit[0])
    traj = on.run_sequence_chunked(seq.odom, seq.ranges, seq.hit, chunk=64)
    lcs = lc_splits_of(on.key_log)
    rep_on = replay_ransac_draws(SEED, seqn.odom, sp_on, lc_splits=lcs)
    logged = [k for n, k in on.key_log if n == "_try_online_loop_closure"]
    if not (len(logged) == len(rep_on.pair_keys) and all(
            np.array_equal(a, b) for a, b in zip(logged, rep_on.pair_keys))
            and np.array_equal(rep_on.key, np.asarray(on._key))):
        raise SystemExit("online: the replayed keys are not JAX's")

    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    np.savez_compressed(
        out,
        off_scan_u=rep_off.scan_u, off_pair_u=np.stack(rep_off.pair_u),
        off_node_T_before=f32(before), off_node_T=f32(after),
        off_link_ref=np.asarray(links.ref, np.int64),
        off_link_mov=np.asarray(links.mov, np.int64),
        off_link_T=f32(links.T), off_link_cov=f32(links.cov),
        off_link_score=f32(links.score), off_link_mask=links.mask,
        off_ransac_T=f32(ransac.T), off_link_T_eps=f32(link_T_eps),
        off_keep=keeps[-1], off_node_scan=np.asarray(node_scan, np.int64),
        off_alt_node_T=f32(alt_after), off_alt_keep=alt_keeps[-1],
        off_n_updates=np.int32(stats["n_updates"]),
        off_edge_ij=np.asarray([e[:2] for e in off.odom_edges], np.int64),
        off_edge_rel=f32([e[2] for e in off.odom_edges]),
        off_edge_cov=f32([e[3] for e in off.odom_edges]),
        **bank,
        off_params_repr=np.str_(repr(sp_off)),
        on_scan_u=rep_on.scan_u,
        on_pair_u=np.stack(rep_on.pair_u) if rep_on.pair_u else np.zeros(
            (0, gp.online_lc_max_candidates, 1, 2), np.float32),
        on_lc_splits=np.asarray(lcs, np.int64),
        on_traj=f32(traj), on_node_T=f32(np.stack(on.node_T)),
        on_loop_links=np.asarray([l[:2] for l in on.loop_links],
                                 np.int64).reshape(-1, 2),
        on_params_repr=np.str_(repr(sp_on)),
    )
    print(f"wrote {out}: offline {len(off.nodes)} nodes, {n_pairs} pairs, "
          f"{int(keeps[-1].sum())} kept links; online {len(on.nodes)} "
          f"nodes, {len(lcs)} proposals, {len(on.loop_links)} loop links")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    ap.add_argument("--lc", action="store_true",
                    help="write the loop-closure record")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    import bench
    from ndt_feature_graph_tpu.config import GraphParams, SLAMParams
    from ndt_feature_graph_tpu.graph.slam import NDTFeatureGraphSLAM

    seq = bench.make_sequence()
    max_cells, fp = bench.verify_cell_budget(bench.canonical_params(), seq)
    if fp.match_cell_budget != bench.MATCH_CELL_BUDGET:
        raise SystemExit(f"cell budget gate failed: {max_cells} cells")
    if args.lc:
        return make_lc_fixture(args.out or LC_OUT, seq, fp)
    args.out = args.out or DEFAULT_OUT
    sparams = SLAMParams(
        fuser=fp,
        graph=GraphParams(new_node_transl_dist=SPLIT_M,
                          max_nodes=MAX_NODES),
    )
    slam = NDTFeatureGraphSLAM(sparams, seed=SEED)
    slam.initialize(seq.gt[0], jnp.zeros(3), seq.ranges[0], seq.hit[0])
    traj = slam.run_sequence_device(seq.odom, seq.ranges, seq.hit)
    draws = replay_ransac_draws(SEED, seq.odom, sparams).scan_u

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(
        args.out,
        ranges=np.asarray(seq.ranges, np.float32),
        hit=np.asarray(seq.hit, bool),
        odom=np.asarray(seq.odom, np.float32),
        gt=np.asarray(seq.gt, np.float32),
        ransac_u=draws,
        traj=np.asarray(traj, np.float32),
        node_T=np.asarray(np.stack(slam.node_T), np.float32),
        edge_rel=np.asarray(np.stack([e[2] for e in slam.odom_edges]),
                            np.float32),
        max_cells=np.int32(max_cells),
        split_m=np.float32(SPLIT_M),
        max_nodes=np.int32(MAX_NODES),
        params_repr=np.str_(repr(sparams)),
    )
    print(f"wrote {args.out}: {traj.shape[0]} poses, "
          f"{len(slam.nodes)} nodes, max cells {max_cells}")


if __name__ == "__main__":
    main()
