"""Graph-SLAM orchestrator: online submap chaining, online loop closure
and offline loop-closure optimization (port of
ndt_feature_graph_tpu/graph/slam.py).

Randomness: the RANSAC draws come from a `torch.Generator` seeded with
`seed` on the device of the first scan, or are passed in — the scan
draws as `ransac_u`, the draws of the link proposals as the queue
`pair_u` — since the reference's jax.random key chain has no torch
counterpart.

Host syncs, as the reference's: one packed readback per node split and
per online link proposal, one source-cell-budget readback per proposal
phase, one stop-flag read per 6-trial Newton chunk, one keep-mask read
per offline fixpoint round, and one readback per pose-graph solve.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ndt_feature_graph_tpu_torch.config import GraphParams, SLAMParams
from ndt_feature_graph_tpu_torch.core import se2
from ndt_feature_graph_tpu_torch.features.descriptor import descriptor_dim
from ndt_feature_graph_tpu_torch.fusion import feature_fuser, scan_driver
from ndt_feature_graph_tpu_torch.graph import links as links_mod
from ndt_feature_graph_tpu_torch.graph import node as node_mod
from ndt_feature_graph_tpu_torch.graph import optimize as opt_mod
from ndt_feature_graph_tpu_torch.graph import sparse_direct as sparse_direct_mod

FEATURE_MAP_CAPACITY = 128


def group_bounds(ref, mov, mask, batch: int, group_nodes: int):
    """The (start, end) pair ranges of the grouped link proposals:
    consecutive candidate pairs (numpy) accumulate until a chunk holds
    `batch` pairs or would reference more than `group_nodes` distinct
    nodes (the reference's rule, graph/slam.py _propose_links_grouped)."""
    bounds, start, nodes_in = [], 0, set()
    for k in range(len(ref)):
        pair = {int(ref[k]), int(mov[k])} if mask[k] else set()
        new = pair - nodes_in
        if k > start and (k - start >= batch
                          or len(nodes_in) + len(new) > group_nodes):
            bounds.append((start, k))
            start, nodes_in, new = k, set(), pair
        nodes_in |= new
    bounds.append((start, len(ref)))
    return bounds


def _np_pose(x):
    return torch.as_tensor(x).detach().cpu().numpy().astype(np.float32)


def _pack_link_outputs(link_set: links_mod.LinkSet):
    """A LinkSet's host-consumed fields as one (C, 14) array [T, cov,
    score, mask], so a proposal pays one readback."""
    c = link_set.T.shape[0]
    return torch.cat([
        link_set.T, link_set.cov.reshape(c, 9), link_set.score[:, None],
        link_set.mask[:, None].to(torch.float32),
    ], 1).cpu().numpy()


class NDTFeatureGraphSLAM:
    """Graph builder: a host orchestrator over device tensors."""

    def __init__(self, params: SLAMParams, seed: int = 0):
        self.params = params
        self.seed = seed
        self.nodes: List[node_mod.NodeData] = []   # frozen nodes
        self.node_T: List[np.ndarray] = []         # global pose per node
        self.odom_edges: List[tuple] = []          # (i, j, rel, cov)
        self.loop_links: List[tuple] = []          # (i, j, rel, cov, score)
        self.state: Optional[feature_fuser.FeatureFuserState] = None
        self.fmap: Optional[node_mod.FeatureMapBuffer] = None
        self.current_T = np.zeros(3, np.float32)   # active node origin
        self.distance_moved = 0.0
        self.n_updates_in_node = 0
        self.generator: Optional[torch.Generator] = None
        # Draws of the link proposals to come, (P, M, 2) each, taken in
        # order; None draws them from the generator.
        self.pair_u: Optional[list] = None
        # The last offline proposal: its LinkSet and final keep mask.
        self.offline_links = None
        self.offline_keep: Optional[np.ndarray] = None
        self.trajectory: List[np.ndarray] = []     # global pose log
        self.times: List[float] = []

    # ---------------- online ----------------

    @property
    def device(self):
        """The device of the active fuser, else of the frozen nodes."""
        if self.state is None:
            return self.nodes[0].T.device
        return self.state.base.Tnow.device

    def _scan_draws(self, n: int):
        return torch.rand(
            (n, self.params.fuser.features.ransac_hypotheses, 2),
            generator=self.generator, device=self.device,
        )

    def _pair_draws(self, p: int):
        """(p, M, 2) RANSAC draws of one link proposal."""
        if self.pair_u is None:
            return self._scan_draws(p)
        u = torch.tensor(np.asarray(self.pair_u.pop(0)),
                         dtype=torch.float32, device=self.device)
        if u.shape != (p, self.params.fuser.features.ransac_hypotheses, 2):
            raise ValueError(f"pair draws of shape {tuple(u.shape)} for a "
                             f"{p}-pair proposal")
        return u

    def initialize(self, init_pose, sensor_pose, ranges, hit, t=0.0):
        """Open the first node with scan 0; the fuser runs in the
        node-local (identity) frame.  The device is that of `ranges`."""
        dev = ranges.device
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(self.seed)
        p = self.params.fuser
        self.current_T = _np_pose(init_pose)
        self.state = feature_fuser.initialize(
            p, torch.zeros(3, device=dev),
            torch.as_tensor(sensor_pose, dtype=torch.float32).to(dev),
            ranges, hit,
        )
        self.fmap = node_mod.empty_feature_map(
            FEATURE_MAP_CAPACITY, descriptor_dim(p.features), dev)
        self._accumulate_features()
        self.trajectory.append(self.current_T.copy())
        self.times.append(t)

    def _accumulate_features(self):
        st = self.state
        self.fmap = node_mod.insert_features(
            self.fmap, st.prev_feats, st.prev_desc,
            se2.compose(st.base.Tnow, st.base.sensor_pose),
        )

    def global_pose(self):
        return se2.compose_np(self.current_T, _np_pose(self.state.base.Tnow))

    def update(self, Tmotion, ranges, hit, t=0.0, u=None):
        """One scan (NDTFeatureGraph::update); u (M, 2) are its RANSAC
        draws (default: from the generator).  Returns the global pose."""
        p = self.params.fuser
        gp = self.params.graph
        self.distance_moved += float(np.linalg.norm(_np_pose(Tmotion)[:2]))
        u = self._scan_draws(1)[0] if u is None else u
        self.state, _info, _res = feature_fuser.update(
            self.state, p, Tmotion, ranges, hit, u)
        if self.distance_moved > gp.new_node_transl_dist and (
            len(self.nodes) + 1 < gp.max_nodes
        ):
            self._finish_split(ranges, hit)
        else:
            self.n_updates_in_node += 1
            if self.n_updates_in_node % p.feature_map_update_incr == 0:
                self._accumulate_features()
        pose = self.global_pose()
        self.trajectory.append(pose)
        self.times.append(t)
        return pose

    def _finish_split(self, ranges, hit):
        """Node split after the split scan was fused into the active
        node: freeze it with its incremental edge, open the next node
        with the same scan, then try online loop closure."""
        dev = self.device
        frozen, rel, cov, new_T, st, fm = scan_driver.split_node(
            self.params.fuser, self.params.graph.incremental_link_source,
            torch.as_tensor(self.current_T, device=dev), self.state,
            self.fmap, ranges, hit,
        )
        packed = torch.cat([new_T, rel, cov.reshape(-1)]).cpu().numpy()
        self._add_node(frozen, self.current_T, packed[3:6],
                       packed[6:].reshape(3, 3))
        self.current_T = packed[:3].copy()
        self.state, self.fmap = st, fm
        self.distance_moved = 0.0
        self.n_updates_in_node = 0
        if self.params.graph.online_loop_closure:
            self._try_online_loop_closure()

    def _add_node(self, frozen, node_T, rel, cov):
        i = len(self.nodes)
        self.nodes.append(frozen)
        self.node_T.append(np.asarray(node_T, np.float32).copy())
        self.odom_edges.append((i, i + 1, rel, cov))

    def _run_segment(self, odom, ranges, hit, times, ransac_u,
                     max_nodes: int):
        """run_graph_sequence over a (T, ...) piece of the sequence; the
        frozen nodes, edges and global poses join the graph."""
        p = self.params.fuser
        gp = self.params.graph
        dev = self.device
        (st, fm, bank, nTb, erel, ecov, traj, cur_T, meta) = (
            scan_driver.run_graph_sequence(
                p, self.state, self.fmap,
                torch.as_tensor(self.current_T, device=dev),
                self.distance_moved, self.n_updates_in_node,
                odom, ranges, hit, gp.new_node_transl_dist,
                max_nodes=max_nodes, fm_incr=p.feature_map_update_incr,
                link_source=gp.incremental_link_source,
                ransac_u=ransac_u, generator=self.generator,
            )
        )
        self.distance_moved, self.n_updates_in_node, n_frozen = meta
        self.state, self.fmap = st, fm
        self.current_T = _np_pose(cur_T)
        if n_frozen:
            nodes = scan_driver.unstack_bank(bank, n_frozen)
            nT, er, ec = (x.cpu().numpy() for x in (nTb, erel, ecov))
            for i in range(n_frozen):
                self._add_node(nodes[i], nT[i], er[i], ec[i])
        self.trajectory.extend(traj.cpu().numpy())
        self.times.extend(times)
        return n_frozen

    def run_sequence_device(self, odom, ranges, hit, times=None,
                            ransac_u=None):
        """Process a whole gated scan sequence (scan 0 already consumed
        by initialize()), node splits into a pre-allocated bank.

        odom (T, 3), ranges (T, B), hit (T, B) on the device;
        ransac_u: optional (T-1, M, 2) RANSAC draws, one row per scan
        after the first (default: drawn from this object's generator).
        Returns the global trajectory (T, 3) as numpy."""
        if self.params.graph.online_loop_closure:
            raise ValueError(
                "run_sequence_device does not handle online loop closure; "
                "use run_sequence_chunked"
            )
        if self.nodes:
            raise ValueError("run_sequence_device requires a fresh graph")
        t_total = ranges.shape[0]
        times = times if times is not None else [0.0] * t_total
        self._run_segment(odom[1:], ranges[1:], hit[1:], list(times[1:]),
                          ransac_u, self.params.graph.max_nodes)
        return np.stack(self.trajectory)

    def run_sequence_chunked(self, odom, ranges, hit, times=None,
                             chunk: int = 16, ransac_u=None):
        """Process a whole gated scan sequence at most `chunk` scans at
        a time, each piece ending at the first node split, which is
        followed by online loop closure (when enabled) — the semantics
        of the reference's loop over its chunk driver (whose contract is
        the port's scan_driver.run_graph_chunk): those of update() per
        scan, except that a split scan whose proposal is accepted is
        logged at its pose before the incremental solve.  Where a scan
        splits depends only on odometry (scan_driver.split_schedule), so
        each piece runs through run_graph_sequence and no chunk's result
        is read back to find it.

        odom (T, 3), ranges (T, B), hit (T, B), scan 0 consumed by
        initialize(); ransac_u optional (T-1, M, 2).  Returns the global
        trajectory (T, 3) as numpy."""
        gp = self.params.graph
        t_total = ranges.shape[0]
        times = times if times is not None else [0.0] * t_total
        odom_np = _np_pose(odom)
        t = 1
        while t < t_total:
            k = min(chunk, t_total - t)
            room = gp.max_nodes - len(self.nodes)
            split = scan_driver.split_schedule(
                odom_np[t:t + k], self.distance_moved,
                self.n_updates_in_node, gp.new_node_transl_dist, room,
                self.params.fuser.feature_map_update_incr,
            )[0]
            n = int(np.argmax(split)) + 1 if split.any() else k
            sl = slice(t, t + n)
            u = None if ransac_u is None else ransac_u[t - 1:t - 1 + n]
            if self._run_segment(odom[sl], ranges[sl], hit[sl],
                                 list(times[sl]), u, room):
                if gp.online_loop_closure:
                    self._try_online_loop_closure()
            t += n
        return np.stack(self.trajectory)

    # ---------------- online loop closure ----------------
    #
    # Extension beyond the reference (which closes loops offline only):
    # on each node split, propose links from the just-frozen node to
    # nearby earlier nodes (feature RANSAC -> D2D refine -> rescore), at
    # static shapes (online_lc_max_candidates pairs), validate on the
    # host and re-solve the pose graph incrementally.

    def _try_online_loop_closure(self):
        gp = self.params.graph
        p = self.params.fuser
        k = len(self.nodes) - 1            # just-frozen node
        if k < gp.valid_min_idx_dist:
            return
        Tk = self.node_T[k]
        cands = sorted(
            c for c in (
                (float(np.linalg.norm(self.node_T[i][:2] - Tk[:2])), i)
                for i in range(k - gp.valid_min_idx_dist + 1)
            ) if c[0] <= gp.online_lc_candidate_dist
        )[: gp.online_lc_max_candidates]
        if not cands:
            return
        cand_idx = [i for (_, i) in cands]

        C = gp.online_lc_max_candidates
        dev = self.device
        # C candidate slots (padded with node k, masked) + node k in slot C.
        sel = cand_idx + [k] * (C - len(cand_idx)) + [k]
        stacked = node_mod.stack_nodes([self.nodes[i] for i in sel])
        ref = torch.arange(C, device=dev)
        mov = torch.full((C,), C, device=dev)
        mask = torch.arange(C, device=dev) < len(cand_idx)
        link_set = links_mod.compute_links_batch(
            p.features, p.ndt.resolution, stacked, ref, mov, mask,
            self._pair_draws(C),
        )
        link_set = links_mod.refine_links_d2d(
            p.ndt, p.matcher, stacked, link_set,
            src_budget=links_mod.source_cell_budget(stacked),
        )
        link_set = links_mod.rescore_links(p.ndt.resolution, stacked,
                                           link_set)

        # Host validation against the current global estimates
        # (getValidLinks gates), from ONE packed readback.
        packed = _pack_link_outputs(link_set)
        T = packed[:, :3]
        cov = packed[:, 3:12].reshape(-1, 3, 3)
        score = packed[:, 12]
        ok = packed[:, 13] > 0.5
        accepted = False
        for m, i in enumerate(cand_idx):
            if not ok[m] or score[m] > gp.valid_max_score:
                continue
            expected = se2.sub_np(self.node_T[i], Tk)
            d = np.linalg.norm(T[m, :2] - expected[:2])
            a = abs(float(np.arctan2(np.sin(T[m, 2] - expected[2]),
                                     np.cos(T[m, 2] - expected[2]))))
            if d > gp.valid_max_dist or a > gp.valid_max_angular_dist:
                continue
            self.loop_links.append((i, k, T[m], cov[m], score[m]))
            accepted = True
        if accepted:
            self._solve_incremental()

    def _edge_list(self, edges, cap: Optional[int] = None):
        """EdgeList on the device from host tuples (i, j, rel, info,
        is_odom), padded to `cap` slots."""
        cap = len(edges) if cap is None else cap
        ne = min(len(edges), cap)
        e_i = np.zeros(cap, np.int64)
        e_j = np.zeros(cap, np.int64)
        e_meas = np.zeros((cap, 3), np.float32)
        e_info = np.zeros((cap, 3, 3), np.float32)
        e_mask = np.zeros(cap, bool)
        e_odom = np.zeros(cap, bool)
        for idx in range(ne):
            i, j, rel, info, odo = edges[idx]
            e_i[idx], e_j[idx] = i, j
            e_meas[idx] = rel
            e_info[idx] = info
            e_mask[idx] = True
            e_odom[idx] = odo
        t = lambda x: torch.as_tensor(x, device=self.device)  # noqa: E731
        return opt_mod.EdgeList(i=t(e_i), j=t(e_j), meas=t(e_meas),
                                info=t(e_info), mask=t(e_mask),
                                is_odom=t(e_odom))

    def _solve_incremental(self):
        """Re-solve the pose graph over the frozen-node origins + the
        active-node origin at static (max_nodes + 1 poses, max_nodes +
        max_links edges) shapes."""
        gp = self.params.graph
        n = len(self.nodes)
        poses = np.zeros((gp.max_nodes + 1, 3), np.float32)
        poses[:n] = np.stack(self.node_T)
        poses[n] = self.current_T
        edges = [
            (i, j, rel, opt_mod.spd_info_np(cov), True)
            for (i, j, rel, cov) in self.odom_edges
        ] + [
            (i, j, rel, opt_mod.spd_info_np(cov, eps=gp.link_info_eps), False)
            for (i, j, rel, cov, _s) in self.loop_links
        ]
        out, _chi2 = opt_mod.optimize(
            torch.as_tensor(poses, device=self.device),
            self._edge_list(edges, gp.max_nodes + gp.max_links),
            prior_information=gp.prior_information,
            iterations=gp.online_lc_gn_iterations,
            damping=gp.gn_damping,
            robust_kernel=gp.online_lc_robust_kernel,
            robust_delta=gp.robust_delta,
        )
        out = out.cpu().numpy()
        self.node_T = [out[i].copy() for i in range(n)]
        self.current_T = out[n].copy()

    def finalize_current_node(self):
        """Freeze the active node without starting a new one (end of
        sequence)."""
        self.nodes.append(node_mod.freeze_node(
            self.params.fuser,
            torch.as_tensor(self.current_T, device=self.device),
            self.state.base, self.fmap,
        ))
        self.node_T.append(np.asarray(self.current_T, np.float32).copy())

    # ---------------- offline ----------------

    def candidate_pairs(self):
        """Node pairs (i < j) at index distance >= valid_min_idx_dist
        (and, with offline_candidate_dist > 0, within that distance of
        each other's current estimate), as padded (ref, mov, mask)
        device tensors."""
        gp = self.params.graph
        n = len(self.nodes)
        if gp.offline_candidate_dist > 0 and n > 1:
            pos = np.stack(self.node_T)[:, :2]
            d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
            near = d2 <= gp.offline_candidate_dist ** 2
            pairs = [(i, j) for i in range(n)
                     for j in range(i + gp.valid_min_idx_dist, n)
                     if near[i, j]]
        else:
            pairs = [(i, j) for i in range(n) for j in range(i + 1, n)
                     if j - i >= gp.valid_min_idx_dist]
        cap = max(len(pairs), 1)
        ref = np.zeros(cap, np.int64)
        mov = np.zeros(cap, np.int64)
        mask = np.zeros(cap, bool)
        for k, (i, j) in enumerate(pairs):
            ref[k], mov[k], mask[k] = i, j, True
        t = lambda x: torch.as_tensor(x, device=self.device)  # noqa: E731
        return t(ref), t(mov), t(mask)

    def _propose_links(self, stacked, ref, mov, mask):
        """Propose -> D2D-refine -> rescore candidate links, in chunks of
        gp.link_batch_size pairs when that is > 0 (else one batch).  With
        gp.link_group_nodes > 0 a chunk also closes before it would
        reference more than that many distinct nodes, and runs against a
        compact sub-bank of those nodes (_propose_links_grouped)."""
        p = self.params.fuser
        gp = self.params.graph
        budget = links_mod.source_cell_budget(stacked)

        def run(stk, ref_c, mov_c, mask_c):
            ls = links_mod.compute_links_batch(
                p.features, p.ndt.resolution, stk, ref_c, mov_c, mask_c,
                self._pair_draws(ref_c.shape[0]),
            )
            ls = links_mod.refine_links_d2d(p.ndt, p.matcher, stk, ls,
                                            src_budget=budget)
            return links_mod.rescore_links(p.ndt.resolution, stk, ls)

        n = int(ref.shape[0])
        B = gp.link_batch_size
        if B <= 0 or n <= B:
            return run(stacked, ref, mov, mask)
        if gp.link_group_nodes > 0:
            # A chunk's first pair can reference 2 distinct nodes, so the
            # sub-bank holds at least 2.
            return self._propose_links_grouped(
                stacked, ref, mov, mask, run, B, max(2, gp.link_group_nodes))
        pad = (-n) % B
        z = torch.zeros(pad, dtype=ref.dtype, device=ref.device)
        ref_p, mov_p = torch.cat([ref, z]), torch.cat([mov, z])
        mask_p = torch.cat([mask, z.to(torch.bool)])
        chunks = [run(stacked, ref_p[c:c + B], mov_p[c:c + B],
                      mask_p[c:c + B]) for c in range(0, n + pad, B)]
        return node_mod.map_tensors(lambda *xs: torch.cat(xs)[:n], *chunks)

    def _propose_links_grouped(self, stacked, ref, mov, mask, run,
                               batch: int, group_nodes: int):
        """Locality-grouped chunking: consecutive pairs accumulate until
        the chunk holds `batch` pairs or would reference more than
        `group_nodes` distinct nodes; the chunk then runs against a
        sub-bank of exactly those nodes (padded to `group_nodes` with the
        first), gathered by index.  Each chunk takes one `batch`-pair draw
        from the queue, in chunk order.  The pair order is kept and the
        outputs carry global node indices."""
        ref_np, mov_np = ref.cpu().numpy(), mov.cpu().numpy()
        mask_np = mask.cpu().numpy()
        dev = ref.device
        outs = []
        for (s, e) in group_bounds(ref_np, mov_np, mask_np, batch,
                                   group_nodes):
            live = [k for k in range(s, e) if mask_np[k]]
            uniq = sorted({int(ref_np[k]) for k in live}
                          | {int(mov_np[k]) for k in live}) or [0]
            local = {g: i for i, g in enumerate(uniq)}
            sel = torch.as_tensor(uniq + [uniq[0]] * (group_nodes - len(uniq)),
                                  device=dev)
            sub = node_mod.map_tensors(lambda x: x[sel], stacked)
            ref_c = np.zeros(batch, np.int64)
            mov_c = np.zeros(batch, np.int64)
            mask_c = np.zeros(batch, bool)
            for k in live:
                ref_c[k - s] = local[int(ref_np[k])]
                mov_c[k - s] = local[int(mov_np[k])]
                mask_c[k - s] = True
            t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
            ls = run(sub, t(ref_c), t(mov_c), t(mask_c))
            cnt = e - s
            outs.append(links_mod.LinkSet(
                ref=ref[s:e], mov=mov[s:e], T=ls.T[:cnt], cov=ls.cov[:cnt],
                score=ls.score[:cnt], mask=ls.mask[:cnt] & mask[s:e]))
        return node_mod.map_tensors(lambda *xs: torch.cat(xs), *outs)

    def _edges_from(self, link_set, link_keep):
        """Odometry edges + kept offline links + the links accepted by
        the online pass (deduplicated against same-pair offline links),
        as an EdgeList."""
        gp = self.params.graph
        n = len(self.nodes)
        edges = [(i, j, rel, opt_mod.spd_info_np(cov), True)
                 for (i, j, rel, cov) in self.odom_edges if j < n]
        kept_pairs = set()
        if link_set is not None:
            T = link_set.T.cpu().numpy()
            cov = link_set.cov.cpu().numpy()
            ref = link_set.ref.cpu().numpy()
            mov = link_set.mov.cpu().numpy()
            for k in np.flatnonzero(link_keep):
                ri, mi = int(ref[k]), int(mov[k])
                kept_pairs.add((ri, mi))
                edges.append((ri, mi, T[k], opt_mod.spd_info_np(
                    cov[k], eps=gp.link_info_eps), False))
        for (i, j, rel, cov, _s) in self.loop_links:
            if j >= n or (i, j) in kept_pairs or (j, i) in kept_pairs:
                continue
            edges.append((i, j, np.asarray(rel), opt_mod.spd_info_np(
                np.asarray(cov), eps=gp.link_info_eps), False))
        return self._edge_list(edges)

    def _solve(self, gp: GraphParams, node_T, edges, robust_delta=None):
        """Solver dispatch: the dense solve for small graphs, the exact
        segment-Schur solve (graph/sparse_direct.py, O(E) memory) beyond
        gp.solver_dense_max_nodes or when gp.solver == "direct"."""
        n = int(node_T.shape[0])
        delta = gp.robust_delta if robust_delta is None else robust_delta
        kw = dict(prior_information=gp.prior_information,
                  iterations=gp.gn_iterations, damping=gp.gn_damping,
                  robust_kernel=gp.robust_kernel, robust_delta=delta)
        if gp.solver == "direct" or (
            gp.solver == "auto" and n > gp.solver_dense_max_nodes
        ):
            part = sparse_direct_mod.make_segments(
                n, edges, max_seg_len=gp.solver_max_seg_len)
            return sparse_direct_mod.optimize_direct(node_T, edges, part,
                                                     **kw)
        return opt_mod.optimize(node_T, edges, **kw)

    def optimize_offline(self, verbose=False):
        """Full offline pipeline: all-pairs feature links -> D2D refine
        -> rescore -> fixpoint loop {validate -> solve} (solve_links).
        Returns the optimized node poses (N, 3) on the device."""
        if len(self.nodes) < 2:
            return torch.as_tensor(np.stack(self.node_T), device=self.device)
        stacked = node_mod.stack_nodes(self.nodes)
        return self.solve_links(
            self._propose_links(stacked, *self.candidate_pairs()), verbose)

    def solve_links(self, link_set: links_mod.LinkSet, verbose=False):
        """The fixpoint loop of optimize_offline over a given LinkSet,
        from the current node poses, with the graduated schedule (round
        0: drift-tolerant gates and the base robust Phi; later rounds:
        the refine gates and Phi), until the kept set repeats.  The
        LinkSet and the final keep mask stay in `offline_links` /
        `offline_keep`; returns the node poses (N, 3) on the device."""
        gp = self.params.graph
        node_T = torch.as_tensor(np.stack(self.node_T), device=self.device)
        prev_keep = None
        for round_idx in range(gp.fixpoint_max_rounds):
            gp_gate, delta = gp, None
            if round_idx >= 1:
                if gp.valid_max_dist_refine > 0:
                    gp_gate = dataclasses.replace(
                        gp, valid_max_dist=gp.valid_max_dist_refine,
                        valid_max_angular_dist=gp.valid_max_angular_refine)
                if gp.robust_delta_refine > 0:
                    delta = gp.robust_delta_refine
            keep = links_mod.valid_links(gp_gate, node_T,
                                         link_set).cpu().numpy()
            if verbose:
                print(f"fixpoint round {round_idx}: {int(keep.sum())} "
                      "valid links")
            if prev_keep is not None and (keep == prev_keep).all():
                break
            prev_keep = keep
            node_T, _chi2 = self._solve(gp, node_T,
                                        self._edges_from(link_set, keep),
                                        robust_delta=delta)
        self.offline_links, self.offline_keep = link_set, prev_keep
        self.node_T = [t.copy() for t in node_T.cpu().numpy()]
        return node_T

    def optimized_trajectory(self):
        """Node-origin trajectory after optimization."""
        return np.stack(self.node_T)

    # ---------------- checkpointing ----------------

    def save(self, path):
        """Checkpoint the frozen graph (nodes, odometry edges, trajectory)
        to one npz in the reference's layout (io/serialize.py): the JAX
        package loads it, and its checkpoints load here."""
        from ndt_feature_graph_tpu_torch.io import serialize

        if not self.nodes:
            raise ValueError("nothing to save: no frozen nodes")
        odom = self.odom_edges or [(0, 0, np.zeros(3), np.eye(3))]
        f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
        serialize.save_pytree(path, {
            "nodes": node_mod.stack_nodes(self.nodes),
            "node_T": f32(np.stack(self.node_T)),
            "odom_i": np.asarray([e[0] for e in odom], np.int32),
            "odom_j": np.asarray([e[1] for e in odom], np.int32),
            "odom_rel": f32(np.stack([e[2] for e in odom])),
            "odom_cov": f32(np.stack([e[3] for e in odom])),
            "n_odom": np.int32(len(self.odom_edges)),
            "trajectory": f32(np.stack(self.trajectory)),
            "times": f32(self.times),
        })

    @classmethod
    def load(cls, path, params: SLAMParams, device=None):
        """Rebuild a graph (ready for optimize_offline) from a checkpoint
        on `device` (None: the CUDA card).  A checkpoint without packed
        tables rebuilds them (serialize.derive_packed)."""
        from ndt_feature_graph_tpu_torch import resolve_device
        from ndt_feature_graph_tpu_torch.io import serialize

        dev = resolve_device(device)
        with np.load(path) as data:
            n_nodes = data["node_T"].shape[0]
            n_odom = int(data["n_odom"])
            n_edges = data["odom_i"].shape[0]
            n_traj = data["trajectory"].shape[0]
            n_times = data["times"].shape[0]
        node = node_mod.empty_node(params.fuser, FEATURE_MAP_CAPACITY, dev)
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        template = {
            # Views: the template gives structure, dtypes and the device.
            "nodes": node_mod.map_tensors(
                lambda x: x.expand((n_nodes,) + x.shape), node),
            "node_T": torch.zeros((n_nodes, 3), **f32),
            "odom_i": torch.zeros(n_edges, **i32),
            "odom_j": torch.zeros(n_edges, **i32),
            "odom_rel": torch.zeros((n_edges, 3), **f32),
            "odom_cov": torch.zeros((n_edges, 3, 3), **f32),
            "n_odom": torch.zeros((), **i32),
            "trajectory": torch.zeros((n_traj, 3), **f32),
            "times": torch.zeros(n_times, **f32),
        }
        tree = serialize.load_pytree(path, template,
                                     derive=serialize.derive_packed)
        slam = cls(params)
        slam.generator = torch.Generator(device=dev)
        slam.generator.manual_seed(slam.seed)
        stacked = tree["nodes"]
        slam.nodes = [node_mod.map_tensors(lambda x, k=k: x[k], stacked)
                      for k in range(n_nodes)]
        host = {k: tree[k].cpu().numpy() for k in tree if k != "nodes"}
        slam.node_T = [t.copy() for t in host["node_T"]]
        slam.odom_edges = [
            (int(host["odom_i"][k]), int(host["odom_j"][k]),
             host["odom_rel"][k].copy(), host["odom_cov"][k].copy())
            for k in range(n_odom)]
        slam.trajectory = [t.copy() for t in host["trajectory"]]
        slam.times = list(host["times"])
        return slam
