"""Cluster preprocessing: numerical factorization + explicit SC assembly,
batched over the subdomains of a cluster (paper §2.2 "preprocessing");
counterpart of ``repro.feti.assembly`` for one device and the dual stage
only, with dense or packed factors.

All subdomains of the structured decomposition share one local topology,
so they share the fill-reducing permutation, the symbolic block fill mask
and the (envelope) stepped metadata: the whole cluster runs through one
batched factorization and one batched assembly with a leading subdomain
axis. The reference plans its stages through a stage graph; an explicit
config has one dual stage, resolved directly here (the autotuner and the
stage graph are ROADMAP item A14, the Dirichlet stage A11, sharding A16).

Host memory: the reference stacks five dense (S, n, n) host copies of K.
Here each subdomain's K is moved to the device once, and the regularized,
permuted stack is built there, in the one working stack the factorization
then overwrites with L. With packed storage that stack is the packed
(S, n_blocks, bs, bs) value stack: no dense (S, n, n) stack exists on the
device at any point.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core import (
    SchurAssemblyConfig,
    SteppedMeta,
    build_stepped_meta,
    make_assembler,
    shared_envelope,
)
from repro_torch.device import resolve_device
from repro_torch.fem.decomposition import FetiProblem
from repro_torch.fem.meshgen import structured_mesh
from repro_torch.fem.regularization import regularization_shift
from repro_torch.feti.config import as_feti_config
from repro_torch.feti.operator import DualMap, dual_map
from repro_torch.sparse import (
    PackedBlockIndex,
    PackedBlocks,
    block_cholesky,
    block_cholesky_packed,
    block_pattern,
    block_symbolic_cholesky,
    matrix_pattern_from_elems,
    node_ordering,
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
    """Everything the solution phase needs, stacked over subdomains."""

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
    f: torch.Tensor  # (S, n) loads (original node order)
    fp: torch.Tensor  # (S, n) loads (factor order)
    dual: DualMap  # multiplier ids + the deterministic scatter slots
    col_perm: torch.Tensor  # (S, m_max) stepped column perm per subdomain
    inv_col_perm: torch.Tensor  # (S, m_max)
    R: torch.Tensor  # (S, n, k) orthonormal kernel bases, original DOF order
    prep: Optional[Callable] = None  # (Kp, Btp) -> (L, F); overwrites Kp

    @property
    def _L_values(self) -> torch.Tensor:
        return self.L.values if isinstance(self.L, PackedBlocks) else self.L

    @property
    def S(self) -> int:
        return self._L_values.shape[0]

    @property
    def device(self) -> torch.device:
        return self._L_values.device

    @property
    def storage(self) -> str:
        """Factor storage actually held ("dense" | "packed")."""
        return "packed" if isinstance(self.L, PackedBlocks) else "dense"

    def device_bytes(self) -> dict:
        """Device bytes of the persistent solution-phase stacks; ``dense_L``
        is what a dense (S, n, n) factor stack would take (not in
        ``total``)."""
        def nbytes(x):
            if x is None:
                return 0
            if isinstance(x, PackedBlocks):
                return x.nbytes
            return x.numel() * x.element_size()

        out = {"L": nbytes(self.L), "K": nbytes(self.K),
               "Btp": nbytes(self.Btp), "F": nbytes(self.F)}
        out["total"] = sum(out.values())
        n = self.index.n
        out["dense_L"] = self.S * n * n * self.Btp.element_size()
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


def make_cluster_preprocessor(problem: FetiProblem, config=None):
    """Host symbolic phase + the numeric preprocessing function for one
    decomposition.

    Returns ``(static, prep)``: ``static`` carries the host-side symbolic
    products (node permutation, block fill mask, stepped envelope, column
    permutations, packed index); ``prep(Kp_stack, Btp_stack) -> (L, F)``
    factorizes the regularized permuted stiffness stack IN PLACE
    (``Kp_stack`` becomes L) and, in explicit mode, assembles the SCs —
    callable again with new values of the same pattern (the paper's
    symbolic/numeric split). ``Kp_stack`` is an (S, n, n) tensor, or with
    ``storage="packed"`` a :class:`PackedBlocks` in the static index.
    """
    fc = as_feti_config(config)
    cfg = fc.resolved_schur()
    dev = resolve_device(fc.device)
    subs = problem.subdomains
    n = subs[0].n
    ndpn = problem.ndof_per_node
    node_shape = tuple(e + 1 for e in problem.elems_per_sub)

    # ---- symbolic phase (host, shared by all subdomains) ----
    nperm = node_ordering(node_shape, fc.ordering)
    lmesh = structured_mesh(problem.elems_per_sub)
    npat0 = matrix_pattern_from_elems(n // ndpn, lmesh.elems)
    kpat0 = expand_node_pattern(npat0, ndpn)
    node_perm = expand_node_perm(nperm, ndpn)
    kpat = kpat0[node_perm][:, node_perm]
    bs, rbs = cfg.block_size, cfg.rhs_bs
    # regularization only touches the diagonal: the pattern is unchanged
    block_mask = block_symbolic_cholesky(block_pattern(kpat, bs))
    metas = [build_stepped_meta(sd.Bt[node_perm] != 0, block_size=bs,
                                rhs_block_size=rbs) for sd in subs]
    env = shared_envelope(metas)
    index = PackedBlockIndex.from_mask(block_mask, n, bs)
    col_perms = np.stack([me.perm for me in metas])
    inv_col_perms = np.stack([me.inv_perm for me in metas])
    cp = torch.as_tensor(col_perms, device=dev)
    icp = torch.as_tensor(inv_col_perms, device=dev)

    def prep(Kp_stack, Btp_stack: torch.Tensor):
        if cfg.storage == "packed":
            L = block_cholesky_packed(Kp_stack, index)
        else:
            L = block_cholesky(Kp_stack, bs, mask=block_mask)
        if not fc.explicit:
            return L, None
        return L, batched_assemble(L, Btp_stack, cp, icp, env, cfg, block_mask)

    static = dict(node_perm=node_perm, block_mask=block_mask, env=env,
                  col_perm=cp, inv_col_perm=icp, cfg=cfg, index=index,
                  device=dev)
    return static, prep


def _device_stiffness(problem: FetiProblem, node_perm: np.ndarray,
                      index: PackedBlockIndex, dev: torch.device,
                      packed: bool = False):
    """The regularized, permuted stiffness stack on ``dev`` — (S, n, n), or
    a :class:`PackedBlocks` when ``packed`` — and the packed unregularized
    permuted K of the lumped preconditioner.

    Each K_i crosses to the device once; permutation, packing and the
    fixing-DOF shift happen there. The shift is added after packing, so the
    packed values are the unregularized ones exactly, and the regularized
    entries are the reference's ``K_ff + ρ`` exactly. On the packed path
    K_i is packed straight from its unpermuted upload by one gather (the
    permutation folded into the gather positions), so no dense (S, n, n)
    stack is built.
    """
    subs = problem.subdomains
    S, n = len(subs), subs[0].n
    inv = np.argsort(node_perm)
    pos = np.stack([inv[sd.fixing_dofs] for sd in subs])  # (S, k) factor order
    rho = np.array([regularization_shift(sd.K) for sd in subs])
    s_idx = torch.arange(S, device=dev)[:, None].expand(pos.shape)
    rho_t = torch.as_tensor(rho, dtype=torch.float64, device=dev)[:, None]
    if packed:
        bs = index.bs
        gather = torch.as_tensor(index.flat_gather(node_perm), device=dev)
        flat = torch.zeros(n * n + 1, dtype=torch.float64, device=dev)
        vals = torch.empty((S, index.n_blocks, bs, bs), dtype=torch.float64,
                           device=dev)
        for i, sd in enumerate(subs):
            flat[: n * n].copy_(torch.as_tensor(sd.K, dtype=torch.float64)
                                .reshape(-1))
            vals[i] = flat[gather].view(index.n_blocks, bs, bs)
        del flat, gather
        K_packed = PackedBlocks(vals, index)
        Kreg = vals.clone()
        index.set_identity_pad(Kreg)
        slot = torch.as_tensor(index.diag_slots[pos // bs], device=dev)
        off = torch.as_tensor(pos % bs, device=dev)
        Kreg[s_idx, slot, off, off] += rho_t
        return PackedBlocks(Kreg, index), K_packed
    perm = torch.as_tensor(node_perm, device=dev)
    Kp = torch.empty((S, n, n), dtype=torch.float64, device=dev)
    for i, sd in enumerate(subs):
        Ki = torch.as_tensor(sd.K, dtype=torch.float64).to(dev)
        Kp[i] = Ki[perm][:, perm]
        del Ki
    K_packed = PackedBlocks(index.pack(Kp), index)
    pos_t = torch.as_tensor(pos, device=dev)
    Kp[s_idx, pos_t, pos_t] += rho_t
    return Kp, K_packed


def preprocess_cluster(problem: FetiProblem, config=None) -> ClusterState:
    """Paper §2.2 'preprocessing': factorize every K_i and (if explicit)
    assemble every F̃ᵢ with the sparsity-utilizing pipeline, on the
    configured device (``cuda`` unless ``FetiConfig(device="cpu")``).

    ``config`` is a :class:`~repro_torch.feti.config.FetiConfig` or
    ``None`` (defaults). The factors are stored as ``cfg.storage`` says;
    the unregularized K kept for the lumped preconditioner is always
    packed in the fill-mask layout.
    """
    fc = as_feti_config(config)
    static, prep = make_cluster_preprocessor(problem, fc)
    dev = static["device"]
    node_perm = static["node_perm"]
    index: PackedBlockIndex = static["index"]
    subs = problem.subdomains

    Kp, K_packed = _device_stiffness(problem, node_perm, index, dev,
                                     packed=static["cfg"].storage == "packed")
    Btp = torch.as_tensor(np.stack([sd.Bt[node_perm] for sd in subs]),
                          dtype=torch.float64, device=dev)
    L, F = prep(Kp, Btp)

    f = np.stack([sd.f for sd in subs])
    lam = np.stack([sd.lambda_ids for sd in subs])
    R = np.stack([sd.R for sd in subs])  # (S, n, k) original order

    def to_dev(x):
        return torch.as_tensor(x, dtype=torch.float64, device=dev)

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
        f=to_dev(f),
        fp=to_dev(f[:, node_perm]),
        dual=dual_map(lam, problem.n_lambda, dev),
        col_perm=static["col_perm"],
        inv_col_perm=static["inv_col_perm"],
        R=to_dev(R),
        prep=prep,
    )
