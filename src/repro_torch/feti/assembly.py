"""Cluster preprocessing: numerical factorization + explicit SC assembly,
batched over the subdomains of a cluster (paper §2.2 "preprocessing");
counterpart of ``repro.feti.assembly`` for one device or one rank of a
:class:`~repro_torch.launch.mesh.FetiMesh`, with dense or packed factors,
the dual stage and, for the Dirichlet preconditioner, the primal boundary
stage S_b = K_bb − K_bi K_ii⁻¹ K_ib.

All subdomains of the structured decomposition share one local topology,
so they share the fill-reducing permutation, the symbolic block fill mask
and the (envelope) stepped metadata: the whole cluster runs through one
batched factorization and one batched assembly with a leading subdomain
axis. Every assembly stage is declared as a
:class:`~repro_torch.core.stages.StageSpec`; with ``schur="auto"`` the
:class:`~repro_torch.core.stages.StageGraph` plans them jointly (one plan
cache entry), else each takes the configured Schur config. Each stage
then runs at its own block size, storage and kernels. When the
boundary/interior split aligns with the row ordering the interior
factorization is shared: the dual rows are ordered
``split.dperm``, so the dual factor's leading (n_i, n_i) principal block IS
the Cholesky factor of the unregularized K_ii, and the Dirichlet stage
reuses it, coerced to its own storage and block size, instead of
factorizing its own copy.

Under a mesh (``FetiConfig.mesh``) every rank runs the host symbolic phase
for the whole cluster, so every rank holds the same global stepped
envelope, column permutations and split, and takes its own slice of the
subdomains (:meth:`~repro_torch.launch.mesh.FetiMesh.owned`): it uploads
only its own K_i, and factorizes and assembles only them. Under
``schur="auto"`` rank 0 plans (and alone reads and writes the plan cache)
and broadcasts the plan: ranks that planned apart could pick different
block sizes, and with them different envelopes.

Host memory: the reference stacks five dense (S, n, n) host copies of K.
Here each subdomain's K is moved to the device once, and the regularized,
permuted stack is built there, in the one working stack the factorization
then overwrites with L; the Dirichlet stage's K_ib, K_bb (and, unshared,
K_ii) are cut from the same upload. With packed storage the working
stacks are packed (n_blocks, bs, bs) value stacks: no dense (S, n, n) or
(S, n_i, n_i) stack exists on the device at any point.

Precision (``FetiConfig.dtype``): each subdomain's K is cut, permuted and
regularized at f64 as it reaches the device and rounded to the storage
dtype as it lands in the working stack, which is held at the compute dtype
(the storage dtype, f32 for bf16); the prep's persistent outputs (L, F̃,
S_b) are rounded back to the storage dtype, as the reference's compiled
prep does. With refinement the f64 regularized K_reg is kept, packed in
the factor's fill-mask layout whatever the factor storage: the one f64
stack below f64.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core import (
    GraphPlan,
    Plan,
    SchurAssemblyConfig,
    StageGraph,
    StageSpec,
    SteppedMeta,
    build_stepped_meta,
    column_pivots,
    make_assembler,
    shared_envelope,
)
from repro_torch.core.autotune import pattern_fingerprint
from repro_torch.core.precision import compute_dtype
from repro_torch.device import resolve_device
from repro_torch.fem.decomposition import FetiProblem
from repro_torch.fem.meshgen import structured_mesh
from repro_torch.fem.regularization import regularization_shift
from repro_torch.feti import dirichlet as dirlib
from repro_torch.feti.config import as_feti_config
from repro_torch.feti.operator import DualMap, dual_map
from repro_torch.launch.mesh import FetiMesh
from repro_torch.obs.trace import annotation, current_tracer
from repro_torch.sparse import (
    PackedBlockIndex,
    PackedBlocks,
    block_cholesky,
    block_cholesky_packed,
    block_pattern,
    block_symbolic_cholesky,
    matrix_pattern_from_elems,
    node_ordering,
    pack_factor,
)

__all__ = ["ClusterState", "preprocess_cluster", "make_cluster_preprocessor",
           "batched_assemble", "expand_node_perm", "expand_node_pattern"]


def expand_node_perm(node_perm: np.ndarray, ndpn: int) -> np.ndarray:
    """Expand a node permutation to node-blocked DOFs (identity for
    ndpn=1): each node's ndpn components move together, staying adjacent."""
    if ndpn == 1:
        return node_perm
    return (node_perm[:, None] * ndpn
            + np.arange(ndpn, dtype=node_perm.dtype)).reshape(-1)


def expand_node_pattern(npat: np.ndarray, ndpn: int) -> np.ndarray:
    """Expand a node adjacency pattern to node-blocked DOFs: every entry
    becomes a dense (ndpn, ndpn) block (identity for ndpn=1)."""
    if ndpn == 1:
        return npat
    return np.kron(npat, np.ones((ndpn, ndpn), dtype=bool))


@dataclasses.dataclass
class ClusterState:
    """Everything the solution phase needs, stacked over subdomains.

    ``cfg`` is the dual stage's resolved config, ``dirichlet_cfg`` the
    Dirichlet stage's; ``plan``/``dirichlet_plan``/``graph_plan`` are the
    autotuner's results under ``schur="auto"`` (else None), and ``stages``
    carries each stage's resolved config, metadata and fill mask
    (:class:`~repro_torch.core.stages.ResolvedStage`)."""

    problem: FetiProblem
    cfg: SchurAssemblyConfig
    env: SteppedMeta  # shared stepped envelope (identity column perm)
    block_mask: np.ndarray  # factor block fill mask (shared)
    node_perm: np.ndarray  # fill-reducing row permutation (shared)
    index: PackedBlockIndex  # packed block layout derived from block_mask
    # device tensors, leading axis = subdomain:
    L: Union[torch.Tensor, PackedBlocks]  # factors of the permuted K_reg:
    # (S, n, n) dense, or packed (S, n_blocks, bs, bs) per cfg.storage
    Btp: torch.Tensor  # (S, n, m_max) row-permuted B̃ᵀ (factor order)
    K: PackedBlocks  # packed permuted unregularized K (lumped preconditioner)
    F: Optional[torch.Tensor]  # (S, m_max, m_max) explicit SCs, or None
    f: torch.Tensor  # (S, n) loads (original node order), solve dtype
    fp: torch.Tensor  # (S, n) loads (factor order), solve dtype
    dual: DualMap  # multiplier ids + the deterministic scatter slots
    col_perm: torch.Tensor  # (S, m_max) stepped column perm per subdomain
    inv_col_perm: torch.Tensor  # (S, m_max)
    R: torch.Tensor  # (S, n, k) orthonormal kernel bases, original DOF order
    prep: Optional[Callable] = None  # (Kp, Btp[, blocks]) -> (L, F, Sb)
    # refinement (reduced storage dtype with refine > 0), else None / 0:
    Kreg: Optional[PackedBlocks] = None  # f64 regularized K, factor order
    refine_steps: int = 0
    # the Dirichlet stage (preconditioner="dirichlet"), else None/False:
    split: Optional[dirlib.BoundaryInteriorSplit] = None
    Sb: Optional[torch.Tensor] = None  # (S, n_b, n_b) own-boundary S_b
    Btb: Optional[torch.Tensor] = None  # (S, n_b, m_max) B̃ᵀ[boundary]
    shared_factor: bool = False  # S_b reused the dual factor's interior
    dirichlet_env: Optional[SteppedMeta] = None  # K_ib's stepped metadata
    dirichlet_mask: Optional[np.ndarray] = None  # interior block fill mask
    dirichlet_cfg: Optional[SchurAssemblyConfig] = None
    # the autotuner (schur="auto"), else None:
    plan: Optional[Plan] = None
    dirichlet_plan: Optional[Plan] = None
    graph_plan: Optional[GraphPlan] = None
    stages: Optional[dict] = None  # stage name -> ResolvedStage
    # distributed FETI: this rank's mesh and the global indices of its
    # subdomains (the stacks above hold those only), else None
    mesh: Optional[FetiMesh] = None
    owned: Optional[range] = None

    @property
    def _L_values(self) -> torch.Tensor:
        return self.L.values if isinstance(self.L, PackedBlocks) else self.L

    @property
    def S(self) -> int:
        """Subdomains in this state's stacks (a rank's own under a mesh)."""
        return self._L_values.shape[0]

    @property
    def device(self) -> torch.device:
        return self._L_values.device

    @property
    def storage(self) -> str:
        """Factor storage actually held ("dense" | "packed")."""
        return "packed" if isinstance(self.L, PackedBlocks) else "dense"

    def device_bytes(self) -> dict:
        """Device bytes of the persistent solution-phase stacks (under a
        mesh, this rank's: they sum over the ranks to the single-device
        bytes); ``dense_L`` and ``dense_K`` are what a dense (S, n, n)
        stack would take (not in ``total``); ``per_stage`` attributes the
        bytes to their stage-graph node, as the reference does (the factor,
        the lumped K, B̃ᵀ, F̃ and K_reg live with the dual stage)."""
        def nbytes(x):
            if x is None:
                return 0
            if isinstance(x, PackedBlocks):
                return x.nbytes
            return x.numel() * x.element_size()

        out = {"L": nbytes(self.L), "K": nbytes(self.K),
               "Btp": nbytes(self.Btp), "F": nbytes(self.F),
               "Sb": nbytes(self.Sb), "Btb": nbytes(self.Btb),
               "Kreg": nbytes(self.Kreg)}
        out["total"] = sum(out.values())
        n = self.index.n
        out["dense_L"] = out["dense_K"] = (self.S * n * n
                                           * self.Btp.element_size())
        out["per_stage"] = {"dual": out["L"] + out["K"] + out["Btp"]
                            + out["F"] + out["Kreg"]}
        if self.Sb is not None:
            out["per_stage"]["dirichlet"] = out["Sb"] + out["Btb"]
        return out


def batched_assemble(
    L: torch.Tensor,
    Btp: torch.Tensor,
    col_perm: torch.Tensor,
    inv_col_perm: torch.Tensor,
    env: SteppedMeta,
    cfg: SchurAssemblyConfig,
    block_mask: Optional[np.ndarray],
) -> torch.Tensor:
    """Assemble all subdomain SCs in one batched pass.

    Per-subdomain *column* permutations (each subdomain has its own stepped
    order) are batched gathers around one envelope-metadata assembler.
    """
    assembler = make_assembler(env, cfg, block_mask)
    S, n, m = Btp.shape
    Bpp = torch.gather(Btp, 2, col_perm[:, None, :].expand(S, n, m))
    Fp = assembler(L, Bpp)  # env has the identity perm
    icp = inv_col_perm
    Fp = torch.gather(Fp, 1, icp[:, :, None].expand(S, m, m))
    return torch.gather(Fp, 2, icp[:, None, :].expand(S, m, m))


def _share_valid(problem: FetiProblem,
                 split: dirlib.BoundaryInteriorSplit) -> bool:
    """The interior-factor dedup is valid iff every subdomain's fixing
    DOFs lie on the (union) boundary: the fixing-DOF regularization then
    only shifts boundary diagonal entries, so the dual factor's leading
    (n_i, n_i) principal block is the Cholesky factor of the UNREGULARIZED
    K_ii, exactly what the Dirichlet stage eliminates against."""
    bset = np.zeros(split.n, dtype=bool)
    bset[split.boundary] = True
    return all(bool(bset[sd.fixing_dofs].all())
               for sd in problem.subdomains)


def make_cluster_preprocessor(problem: FetiProblem, config=None):
    """Host symbolic phase + the numeric preprocessing function for one
    decomposition.

    Returns ``(static, prep)``: ``static`` carries the host-side symbolic
    products (node permutation, block fill mask, stepped envelope, column
    permutations (``owned``'s: under ``FetiConfig.mesh`` the rank's
    slice, every subdomain else), packed index and, with the Dirichlet
    preconditioner, the split, the sharing decision, K_ib's stepped
    metadata and the interior fill mask and index), each stage's resolved
    config, the stage graph and, under ``schur="auto"``, its joint plan
    (planning runs here: the measured step times candidates on the
    configured device);
    ``prep(Kp_stack, Btp_stack, blocks=None) ->
    (L, F, Sb)`` factorizes the regularized permuted stiffness stack IN
    PLACE (``Kp_stack`` becomes L), in explicit mode assembles the SCs, and
    given the Dirichlet stage's :class:`~repro_torch.feti.dirichlet.
    DirichletBlocks` assembles the own-boundary S_b stack (its K_ii, when
    unshared, is factorized in place too); F and Sb are ``None`` when not
    computed. It is callable again with new values of the same pattern
    (the paper's symbolic/numeric split). ``Kp_stack`` is an (S, n, n)
    tensor, or with ``storage="packed"`` a :class:`PackedBlocks` in the
    static index.
    """
    fc = as_feti_config(config)
    dev = resolve_device(fc.device)
    subs = problem.subdomains
    S = len(subs)
    owned = fc.mesh.owned(S) if fc.mesh is not None else range(S)
    n = subs[0].n
    ndpn = problem.ndof_per_node
    node_shape = tuple(e + 1 for e in problem.elems_per_sub)

    # ---- symbolic phase (host, shared by all subdomains) ----
    nperm = node_ordering(node_shape, fc.ordering)
    lmesh = structured_mesh(problem.elems_per_sub)
    npat0 = matrix_pattern_from_elems(n // ndpn, lmesh.elems)
    kpat0 = expand_node_pattern(npat0, ndpn)  # original DOF order
    fill_perm = expand_node_perm(nperm, ndpn)

    # ---- Dirichlet stage: the split and the factor-sharing decision ----
    split = None
    share = False
    if fc.dirichlet:
        split = dirlib.boundary_interior_split(problem, dof_perm=fill_perm)
        if fc.share_factor is not False and split.n_i > 0:
            ok = _share_valid(problem, split)
            if fc.share_factor is True and not ok:
                raise ValueError(
                    "share_factor=True, but some subdomain's fixing DOFs "
                    "are interior — the regularization would perturb the "
                    "shared interior factor. Use share_factor='auto'.")
            share = ok

    # factor row order: the boundary/interior layout when sharing (the
    # interior keeps its fill-reducing elimination order, so the leading
    # principal block of L is the interior factor), else the fill order
    node_perm = split.dperm if share else fill_perm
    kpat = kpat0[node_perm][:, node_perm]
    patterns = [sd.Bt[node_perm] != 0 for sd in subs]

    # each stage's symbolic products at a (bs, rbs): what the planner
    # scores at every candidate size and the resolved stages run with,
    # memoized so the chosen size is not analyzed twice
    _built: dict = {}

    def _symbolic(bs: int, rbs: int):
        key = (bs, rbs)
        if key not in _built:
            # regularization only touches the diagonal: pattern unchanged
            mask = block_symbolic_cholesky(block_pattern(kpat, bs))
            metas = [build_stepped_meta(p, block_size=bs, rhs_block_size=rbs)
                     for p in patterns]
            _built[key] = (metas, shared_envelope(metas), mask)
        return _built[key]

    _dbuilt: dict = {}

    def _dsymbolic(bs: int, rbs: int):
        key = (bs, rbs)
        if key not in _dbuilt:
            _dbuilt[key] = dirlib.dirichlet_symbolic(problem, split, bs, rbs,
                                                     kpat=kpat0)
        return _dbuilt[key]

    # ---- the stage graph: every assembly stage, planned as one unit ----
    piv = np.stack([column_pivots(p) for p in patterns])
    specs = [StageSpec(
        name="dual",
        builder=lambda bs, rbs: _symbolic(bs, rbs)[1:],
        fingerprint=pattern_fingerprint(
            piv, n, problem.m_max,
            extra=[kpat.sum(axis=1).astype(np.int64), node_perm]),
        n=n, storage=fc.storage, dtype=fc.dtype_name, batch=len(owned),
        # without explicit assembly only the factorization block size
        # matters: no timed assembly micro-runs for it
        measure=None if fc.explicit else "never",
    )]
    if fc.dirichlet and split.n_i > 0:
        specs.append(StageSpec(
            name="dirichlet",
            builder=_dsymbolic,
            fingerprint=dirlib.dirichlet_fingerprint(problem, split,
                                                     kpat=kpat0),
            n=split.n_i, storage=fc.storage, dtype=fc.dtype_name,
            batch=len(owned), share_factor_of="dual" if share else None,
        ))
    graph = StageGraph(specs)

    plan = d_plan = gplan = None
    if fc.auto:
        # one plan for every rank: rank 0 plans, the others receive it
        if fc.mesh is None or fc.mesh.rank == 0:
            gplan = graph.plan(measure=fc.measure, cache=fc.plan_cache,
                               torch_device=dev)
        if fc.mesh is not None:
            gplan = fc.mesh.broadcast_object(gplan)
        plan = gplan["dual"]
        cfg = plan.cfg
        d_plan = gplan.plans.get("dirichlet")
    else:
        cfg = fc.resolved_schur()
    # without a plan of its own the Dirichlet stage takes the dual's config
    d_cfg = d_plan.cfg if d_plan is not None else cfg
    cfgs = {"dual": cfg}
    if "dirichlet" in graph.by_name:
        cfgs["dirichlet"] = d_cfg
    resolved = graph.resolve(cfgs, plans=gplan.plans if gplan else None)

    bs = cfg.block_size
    packed = cfg.storage == "packed"
    metas, env, block_mask = _symbolic(bs, cfg.rhs_bs)
    index = PackedBlockIndex.from_mask(block_mask, n, bs)
    col_perms = np.stack([metas[i].perm for i in owned])
    inv_col_perms = np.stack([metas[i].inv_perm for i in owned])
    cp = torch.as_tensor(col_perms, device=dev)
    icp = torch.as_tensor(inv_col_perms, device=dev)

    meta_ib = mask_ii = index_ii = d_assemble = Zb = None
    if fc.dirichlet:
        meta_ib, mask_ii = _dsymbolic(d_cfg.block_size, d_cfg.rhs_bs)
        if d_cfg.storage == "packed" and split.n_i > 0:
            index_ii = PackedBlockIndex.from_mask(mask_ii, split.n_i,
                                                  d_cfg.block_size)
        d_assemble = dirlib.make_dirichlet_assembler(
            split, meta_ib, mask_ii, d_cfg, shared=share)
        Zb = torch.as_tensor(
            dirlib.own_boundary_masks(problem, split, owned),
            dtype=fc.compute_dtype, device=dev)
    ni = split.n_i if split is not None else 0

    def _interior_factor(L):
        """The dual factor's leading (n_i, n_i) principal block in the
        Dirichlet stage's storage and block size: a view of a dense stack,
        or packed in the interior layout. A packed dual factor is densified
        for the cut, a transient dense (S, n, n) stack as in the reference
        (avoiding it is ROADMAP A11's follow-up)."""
        Ld = L.unpack() if isinstance(L, PackedBlocks) else L
        if index_ii is not None:
            return pack_factor(Ld[:, :ni, :ni], index_ii)
        return Ld[:, :ni, :ni]

    def prep(Kp_stack, Btp_stack: torch.Tensor,
             blocks: Optional[dirlib.DirichletBlocks] = None):
        # the current tracer's spans (no-ops without one): each stage's
        # outputs are synchronized at its span's close
        tr = current_tracer()
        with tr.span("stage:dual") as sp:
            if packed:
                L = block_cholesky_packed(Kp_stack, index)
            else:
                L = block_cholesky(Kp_stack, bs, mask=block_mask)
            F = (batched_assemble(L, Btp_stack, cp, icp, env, cfg,
                                  block_mask)
                 if fc.explicit else None)
            sp.sync(L, F)
        Sb = None
        if blocks is not None:
            with tr.span("stage:dirichlet") as sp:
                A_ii = _interior_factor(L) if share else blocks.Kii
                Sb = dirlib.restrict_own_boundary(
                    d_assemble(A_ii, blocks.Kib, blocks.Kbb), Zb)
                sp.sync(Sb)
        return L, F, Sb

    static = dict(node_perm=node_perm, block_mask=block_mask, env=env,
                  col_perm=cp, inv_col_perm=icp, cfg=cfg, index=index,
                  device=dev, split=split, share=share,
                  dirichlet_cfg=d_cfg if fc.dirichlet else None,
                  dirichlet_env=meta_ib, dirichlet_mask=mask_ii,
                  dirichlet_index=index_ii, plan=plan, dirichlet_plan=d_plan,
                  graph=graph, graph_plan=gplan, stages=resolved,
                  owned=owned)
    return static, prep


def _device_stiffness(problem: FetiProblem, node_perm: np.ndarray,
                      index: PackedBlockIndex, dev: torch.device,
                      packed: bool = False,
                      blocks: Optional[dirlib.DirichletBlocks] = None,
                      keep_reg: bool = False,
                      storage: torch.dtype = torch.float64,
                      owned: Optional[range] = None):
    """The regularized, permuted stiffness stack on ``dev`` — (S, n, n), or
    a :class:`PackedBlocks` when ``packed`` — and the packed unregularized
    permuted K of the lumped preconditioner; ``blocks`` (the Dirichlet
    stage's inputs) are cut from the same uploads. With ``keep_reg`` also
    returns the regularized stack packed at f64 (the K_reg of refinement),
    else ``None``. ``owned`` (one rank's slice) uploads those subdomains
    only.

    Each K_i crosses to the device once; permutation, packing and the
    fixing-DOF shift happen there at f64, one subdomain at a time, and each
    result is rounded to ``storage`` as it lands in its stack: the
    unregularized K at ``storage``, the working stack at the dtype the
    factorization runs in (f32 for bf16). So the only (S, ...) f64 stack
    built below f64 is the packed K_reg. The shift is added after packing,
    so the packed values are the unregularized ones exactly, and the
    regularized entries are the reference's ``K_ff + ρ`` exactly. Every
    packed stack is one gather from K_i's unpermuted upload (the
    permutation folded into the gather positions), so the packed path
    builds no dense (n, n) matrix.
    """
    subs = [problem.subdomains[i] for i in
            (owned if owned is not None else range(problem.n_subdomains))]
    S, n, bs = len(subs), subs[0].n, index.bs
    inv = np.argsort(node_perm)
    pos = np.stack([inv[sd.fixing_dofs] for sd in subs])  # (S, k) factor order
    rho = torch.as_tensor([regularization_shift(sd.K) for sd in subs],
                          dtype=torch.float64, device=dev)
    slot = torch.as_tensor(index.diag_slots[pos // bs], device=dev)
    off = torch.as_tensor(pos % bs, device=dev)
    pos_t = torch.as_tensor(pos, device=dev)
    gather = torch.as_tensor(index.flat_gather(node_perm), device=dev)
    perm = torch.as_tensor(node_perm, device=dev)
    vshape = (S, index.n_blocks, bs, bs)
    work = torch.empty(vshape if packed else (S, n, n),
                       dtype=compute_dtype(storage), device=dev)
    K_packed = torch.empty(vshape, dtype=storage, device=dev)
    Kreg = (torch.empty(vshape, dtype=torch.float64, device=dev)
            if keep_reg else None)
    # each K_i lands in one flat buffer with a zero appended (the padding
    # target of the packing gathers)
    flat = torch.zeros(n * n + 1, dtype=torch.float64, device=dev)
    for i, sd in enumerate(subs):
        flat[: n * n].copy_(torch.as_tensor(sd.K, dtype=torch.float64)
                            .reshape(-1))
        if blocks is not None:
            blocks.add(i, flat)
        Kb = flat[gather].view(index.n_blocks, bs, bs)  # unregularized
        K_packed[i] = Kb
        if packed or keep_reg:
            index.set_identity_pad(Kb)
            Kb[slot[i], off[i], off[i]] += rho[i]
            if keep_reg:
                Kreg[i] = Kb
        if packed:
            work[i] = Kb.to(storage)
        else:
            Ki = flat[: n * n].view(n, n)[perm][:, perm]
            Ki[pos_t[i], pos_t[i]] += rho[i]
            work[i] = Ki.to(storage)
    del flat
    return (PackedBlocks(work, index) if packed else work,
            PackedBlocks(K_packed, index),
            PackedBlocks(Kreg, index) if keep_reg else None)


def preprocess_cluster(problem: FetiProblem, config=None) -> ClusterState:
    """Paper §2.2 'preprocessing': factorize every K_i and (if explicit)
    assemble every F̃ᵢ with the sparsity-utilizing pipeline, on the
    configured device (``cuda`` unless ``FetiConfig(device="cpu")``).

    ``config`` is a :class:`~repro_torch.feti.config.FetiConfig` or
    ``None`` (defaults). The factors are stored as ``cfg.storage`` says;
    the unregularized K kept for the lumped preconditioner is always
    packed in the fill-mask layout.

    ``preconditioner="dirichlet"`` also assembles the per-subdomain primal
    boundary Schur complements S_b = K_bb − K_bi K_ii⁻¹ K_ib
    (:mod:`repro_torch.feti.dirichlet`) through the same assembly config
    (under ``schur="auto"``, the stage's own plan: the state's ``plan``,
    ``dirichlet_plan``, ``graph_plan`` and ``stages``);
    the state then carries ``Sb``, the boundary-row slice ``Btb``, the
    split and ``shared_factor``: whether the stage reused the dual factor's
    interior principal block instead of factorizing K_ii itself.

    Under ``FetiConfig.mesh`` the state holds the rank's own subdomains
    (``owned``) only, with the global symbolic products, the global
    multiplier space (``dual`` built ``sliced``) and every rank's plan.

    Below f64 (``FetiConfig.dtype``) the stacks L, F, Sb, K, Btp and Btb
    are at the storage dtype, computed at the compute dtype; f, fp and R
    carry the solve dtype; with refinement ``Kreg`` holds the f64
    regularized K (packed) and ``refine_steps`` the steps.

    Spans (on the current tracer, :func:`repro_torch.obs.use_tracer`; the
    reference's names and nesting): ``init`` around the symbolic phase and
    planning (the planner's ``plan:*`` spans inside it); ``prep``, under
    ``annotation("feti.prep")``, around the numeric phase with its
    children ``stage:dual`` (the factorization and the dual assembly) and,
    with the Dirichlet preconditioner, ``stage:dirichlet``; then ``pack``.
    Each span synchronizes the tensors it produced before it closes. The
    port runs the dual stage and then the Dirichlet stage, so each stage
    span times its own stage; the reference's compiled prep computes both
    in one call, and its ``stage:dirichlet`` is only the tail that remains
    after the dual outputs are ready. The stiffness upload, which also
    packs the lumped preconditioner's K and refinement's K_reg (each K_i
    crosses to the device once), runs between ``init`` and ``prep``, in no
    span of its own, as the reference's uploads do; ``pack`` holds the
    persistent outputs' rounding to the storage dtype and the loads'
    upload.
    """
    fc = as_feti_config(config)
    tr = current_tracer()
    with tr.span("init"):
        static, prep = make_cluster_preprocessor(problem, fc)
    sdt, cdt, vdt = fc.storage_dtype, fc.compute_dtype, fc.solve_dtype
    refine = fc.resolved_refine()
    dev = static["device"]
    node_perm = static["node_perm"]
    index: PackedBlockIndex = static["index"]
    split = static["split"]
    share = static["share"]
    owned = static["owned"]
    subs = [problem.subdomains[i] for i in owned]

    blocks = Btb = None
    if split is not None:
        blocks = dirlib.DirichletBlocks(split, len(subs), dev,
                                        interior=not share,
                                        index_ii=static["dirichlet_index"],
                                        storage=sdt)
        Btb = torch.as_tensor(np.stack([sd.Bt[split.boundary] for sd in subs]),
                              dtype=sdt, device=dev)
    # the working stack and the Dirichlet blocks hold what the storage dtype
    # holds, at the dtype the math runs in
    Kp, K_packed, Kreg = _device_stiffness(
        problem, node_perm, index, dev,
        packed=static["cfg"].storage == "packed", blocks=blocks,
        keep_reg=refine > 0, storage=sdt, owned=owned)
    Btp = torch.as_tensor(np.stack([sd.Bt[node_perm] for sd in subs]),
                          dtype=sdt, device=dev)
    with tr.span("prep"), annotation("feti.prep"):
        L, F, Sb = prep(Kp, Btp.to(cdt), blocks)
    del blocks, Kp

    def to_dev(x):
        return torch.as_tensor(x, dtype=vdt, device=dev)

    with tr.span("pack") as sp:
        # the persistent outputs at the storage dtype (no copy when it is
        # the compute dtype)
        L = L.to(sdt)
        F = None if F is None else F.to(sdt)
        Sb = None if Sb is None else Sb.to(sdt)
        f = np.stack([sd.f for sd in subs])
        lam = np.stack([sd.lambda_ids for sd in subs])
        R = np.stack([sd.R for sd in subs])  # (S, n, k) original order
        f_dev, fp_dev = to_dev(f), to_dev(f[:, node_perm])
        sp.sync(L, F, Sb, f_dev, fp_dev)

    return ClusterState(
        problem=problem,
        cfg=static["cfg"],
        env=static["env"],
        block_mask=static["block_mask"],
        node_perm=node_perm,
        index=index,
        L=L,
        Btp=Btp,
        K=K_packed,
        F=F,
        f=f_dev,
        fp=fp_dev,
        dual=dual_map(lam, problem.n_lambda, dev,
                      sliced=fc.mesh is not None),
        col_perm=static["col_perm"],
        inv_col_perm=static["inv_col_perm"],
        R=to_dev(R),
        prep=prep,
        Kreg=Kreg,
        refine_steps=refine,
        split=split,
        Sb=Sb,
        Btb=Btb,
        shared_factor=share,
        dirichlet_env=static["dirichlet_env"],
        dirichlet_mask=static["dirichlet_mask"],
        dirichlet_cfg=static["dirichlet_cfg"],
        plan=static["plan"],
        dirichlet_plan=static["dirichlet_plan"],
        graph_plan=static["graph_plan"],
        stages=static["stages"],
        mesh=fc.mesh,
        owned=owned,
    )
