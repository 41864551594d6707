"""Sharding over several devices: a mesh, the distributed MSM and NTT.

Counterpart of zkrollup/dist/mesh.py, where every function is a jitted
shard_map over a jax.sharding.Mesh. PyTorch has no single-controller
shard_map, so here:

  Mesh     an ordered list of torch devices, the shards this process
           drives, and optionally a torch.distributed process group whose
           processes each drive as many: D = processes x local shards,
           this process's shards at global indices rank x local ... A
           device may repeat (make_mesh(4, device="cuda:0") is a virtual
           mesh of four shards on one card, as JAX's tests force eight
           host devices).
  sharded  a value split over the mesh is the list of this process's
           shards, one tensor (or point) on each of its devices, in mesh
           order.

The three exchanges the reference's programs make (an all_gather of the
NTT rows, the all_to_all of the relayout, the gather of the D partial MSM
results before the fold) are Mesh.all_gather, Mesh.all_to_all and
Mesh.gather, each written once with two routes: one process driving all
of its shards (copies between devices, peer copies on a real multi-card
mesh), or a process group (all_gather_into_tensor, all_to_all_single).
A gloo group moves CPU tensors only, so a CUDA mesh on gloo stages each
exchange through host memory (Mesh.staged); the arithmetic stays on the
devices. The sharded functions are written once over the exchanges, and
their results do not depend on whether shards share a device.

  MSM   points and scalars split into D contiguous blocks; each shard runs
        msm.window_sums on its block (distinct=False: padded tables hold
        infinity rows, and the a table duplicate points, so the complete
        adds), then the D shards' window sums are gathered and folded on
        the safe add (g1_add / g2_add), the count padded
        with infinity to a power of two, and combined once (the Horner
        kernel in sharded_msm_g1/g2; on the host in the prover).
  NTT   four-step, n = D x L, cyclic in and blocked out: each shard's
        residue class through the local NTT_L (ntt.transform, the ntt_pass
        kernel) with the middle twiddle w_n^(j1 k2) (and 1/n for the
        inverse) as the transform's post table, then the D-point transform
        across shards: the rows all-gathered, multiplied by w_D^(j1 k1)
        (mont_mul[fr]) and summed on FR.add (add[fr]).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..curve.g1 import G1
from ..curve.g2 import G2
from ..fields import limbs as L
from ..fields.mont import FR
from ..msm import msm as msm_mod
from ..ntt import ntt as ntt_mod
from .launch import init_distributed  # noqa: F401  (the reference's export)


class Mesh:
    """This process's shards of a 1-D mesh: `devices` in mesh order, and
    the process group the mesh spans (None: this process drives every
    shard)."""

    def __init__(self, devices, group=None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = group
        self.local = len(self.devices)
        self.rank = 0 if group is None else dist.get_rank(group)
        self.world = 1 if group is None else dist.get_world_size(group)
        self.size = self.local * self.world
        self.first = self.rank * self.local
        # gloo moves CPU tensors only: a CUDA mesh's exchanges go through
        # host memory there
        self.staged = (group is not None and dist.get_backend(group) == "gloo"
                       and self.devices[0].type == "cuda")

    def __repr__(self):
        return (f"Mesh({self.size} shards; this process {self.first}.."
                f"{self.first + self.local - 1} on "
                f"{', '.join(map(str, self.devices))})")

    def shard_ids(self) -> range:
        """Global indices of this process's shards."""
        return range(self.first, self.first + self.local)

    def put(self, stacked) -> list:
        """(D, ...) rows -> this process's shards: row g on the device of
        global shard g, contiguous."""
        if stacked.shape[0] != self.size:
            raise ValueError(f"{stacked.shape[0]} rows for a mesh of "
                             f"{self.size} shards")
        return [_to(stacked[g], d) for g, d in zip(self.shard_ids(),
                                                   self.devices)]

    # -- the exchanges -------------------------------------------------------

    def _comm_device(self):
        return torch.device("cpu") if self.staged else self.devices[0]

    def _gathered(self, shards) -> torch.Tensor:
        """Every shard's tensor, stacked in mesh order, on one device."""
        if len(shards) != self.local:
            raise ValueError(f"{len(shards)} shards for {self.local} local "
                             "devices")
        if self.group is None:
            d0 = self.devices[0]
            return torch.stack([s.to(d0) for s in shards])
        comm = self._comm_device()
        send = torch.stack([s.to(comm) for s in shards]).contiguous()
        out = send.new_empty((self.size,) + tuple(send.shape[1:]))
        dist.all_gather_into_tensor(out, send, group=self.group)
        return out

    def all_gather(self, shards) -> list:
        """Each shard's tensor -> on each shard, every shard's tensor
        stacked in mesh order: (D, ...)."""
        if self.group is None:
            return [torch.stack([s.to(d) for s in shards])
                    for d in self.devices]
        rows = self._gathered(shards)
        return [rows.to(d) for d in self.devices]

    def gather(self, shards) -> torch.Tensor:
        """Each shard's tensor -> every shard's, stacked in mesh order,
        (D, ...) on this process's first device."""
        return self._gathered(shards).to(self.devices[0])

    def all_to_all(self, pieces) -> list:
        """pieces[a] (D, ...) of local shard a: row r goes to global shard
        r. Returns, on each local shard, (D, ...) with row k from global
        shard k."""
        if len(pieces) != self.local:
            raise ValueError(f"{len(pieces)} shards for {self.local} local "
                             "devices")
        if self.group is None:
            return [torch.stack([p[r].to(d) for p in pieces])
                    for r, d in enumerate(self.devices)]
        comm = self._comm_device()
        rest = tuple(pieces[0].shape[1:])
        # send[q, a, b]: local shard a's row for shard b of process q
        send = torch.stack([p.to(comm) for p in pieces]).reshape(
            (self.local, self.world, self.local) + rest).transpose(0, 1)
        send = send.contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        # recv[p, a, b]: from shard a of process p for local shard b
        return [recv[:, :, b].reshape((self.size,) + rest).to(d)
                for b, d in enumerate(self.devices)]


def make_mesh(n_devices: Optional[int] = None, device=None,
              group=None, local_rank: Optional[int] = None) -> Mesh:
    """A mesh of n_devices shards in this process. With a device ("cuda:0",
    "cpu"): a virtual mesh of n_devices shards on it (default 1). With no
    device: visible CUDA devices, and an error without one. The mesh spans
    `group`, by default torch.distributed's world when it is initialised
    with more than one process (init_distributed), each process passing
    its own shards; there each process takes its own cards, local_rank x
    n .. local_rank x n + n - 1, local_rank by default its rank in the
    group and n by default the visible cards over the group's processes
    (every process on one host). Processes on several hosts pass
    local_rank (their index on their host) and n_devices. Cards past the
    visible ones raise: no two processes of one host share a card."""
    if group is None and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        group = dist.group.WORLD
    if device is not None:
        return Mesh([torch.device(device)] * (n_devices or 1), group)
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("make_mesh: no CUDA device; pass device= "
                           "(\"cpu\" for a CPU mesh)")
    procs = 1 if group is None else dist.get_world_size(group)
    if local_rank is None:
        local_rank = 0 if group is None else dist.get_rank(group)
    n = n_devices or count // procs
    lo = local_rank * n
    if n < 1 or lo + n > count:
        raise ValueError(f"make_mesh: process {local_rank} of {procs} would "
                         f"take cards {lo}..{lo + n - 1}, {count} visible; "
                         "pass n_devices, local_rank, or device= for a "
                         "virtual mesh")
    return Mesh([torch.device("cuda", lo + i) for i in range(n)], group)


def submeshes(mesh: Mesh, n_groups: int) -> list:
    """Split a single-process mesh into n_groups disjoint meshes of
    consecutive shards: the five MSM tables go to disjoint device groups
    (distributed_prove_core's table_groups)."""
    if mesh.group is not None:
        raise ValueError("submeshes: a mesh over a process group is not "
                         "split (one group of processes a table)")
    if mesh.local % n_groups:
        raise ValueError("device count must split evenly")
    per = mesh.local // n_groups
    return [Mesh(mesh.devices[i * per:(i + 1) * per])
            for i in range(n_groups)]


# -- layouts -------------------------------------------------------------------

def cyclic_shard(x: torch.Tensor, d: int) -> torch.Tensor:
    """(n, 16) -> (D, n/D, 16) residue-class rows for sharded_ntt: row j1
    holds x[j1 + D j2]."""
    n = x.shape[0]
    return x.reshape(n // d, d, L.N_LIMBS).transpose(0, 1)


def block_shard(x: torch.Tensor, d: int) -> torch.Tensor:
    """(n, 16) -> (D, n/D, 16) contiguous blocks (inverse of unblock)."""
    n = x.shape[0]
    return x.reshape(d, n // d, L.N_LIMBS)


def unblock(x_blocked) -> torch.Tensor:
    """(D, L, 16) contiguous blocks, or a list of D block shards -> (n, 16)
    natural order (the shards on the first one's device)."""
    if isinstance(x_blocked, (list, tuple)):
        x_blocked = torch.stack([s.to(x_blocked[0].device)
                                 for s in x_blocked])
    d, l, _ = x_blocked.shape
    return x_blocked.reshape(d * l, L.N_LIMBS)


def _to(a, device) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        return L.to_device(a, device)
    return a.to(device).contiguous()


def _shards(mesh: Mesh, x) -> list:
    """A sharded argument: a list of this process's shards as it is, or a
    (D, ...) tensor put on the mesh."""
    if isinstance(x, (list, tuple)):
        if len(x) != mesh.local:
            raise ValueError(f"{len(x)} shards for {mesh.local} local "
                             "devices")
        return list(x)
    return mesh.put(x)


# -- device tables, per (kind, log_n, D, shard, device) ------------------------

_DEV_TABLES = {}


def _dev_table(kind: str, log_n: int, d: int, g: int, device, build):
    key = (kind, log_n, d, g, str(device))
    t = _DEV_TABLES.get(key)
    if t is None:
        t = _to(build(), device)
        _DEV_TABLES[key] = t
    return t


def _twiddle_post(log_n: int, d: int, inverse: bool, g: int) -> np.ndarray:
    """(L, 16) Montgomery post table of shard g's local transform: the
    middle twiddle w_n^(g k2) (w_n^-1 for the inverse, times 1/n: the
    local inverse transform is unscaled)."""
    n = 1 << log_n
    w = ntt_mod.domain_root(log_n)
    scale = 1
    if inverse:
        w = pow(w, FR.p - 2, FR.p)
        scale = pow(n, FR.p - 2, FR.p)
    return ntt_mod._powers_host(log_n - (d.bit_length() - 1),
                                pow(w, g, FR.p), scale, True)


def _dft_column(d: int, inverse: bool, k1: int, l: int) -> np.ndarray:
    """(D, L, 16) Montgomery w_D^(j1 k1) of shard k1's column, each row
    repeated over the L rows it multiplies."""
    if d & (d - 1):
        raise ValueError("device count must be a power of two")
    w = ntt_mod.domain_root(d.bit_length() - 1)
    if inverse:
        w = pow(w, FR.p - 2, FR.p)
    col = FR.to_mont_host([pow(w, j * k1 % d, FR.p) for j in range(d)])
    return np.ascontiguousarray(np.broadcast_to(col[:, None, :],
                                                (d, l, L.N_LIMBS)))


def _fold_rows(terms: torch.Tensor) -> torch.Tensor:
    """Sum of (D, L, 16) rows mod r, halving on FR.add (D a power of
    two)."""
    m = terms.shape[0]
    while m > 1:
        half = m // 2
        terms = FR.add(terms[:half], terms[half:m])
        m = half
    return terms[0]


# -- distributed NTT (four-step) -----------------------------------------------

def sharded_ntt(mesh: Mesh, x_cyclic, log_n: int,
                inverse: bool = False) -> list:
    """Distributed NTT over n = 2^log_n Montgomery-form elements.

    x_cyclic: shard j1 holds the residue class x[j1 + D j2], j2 < L (a list
    of shards, or the (D, L, 16) tensor of cyclic_shard). Returns the
    shards of the contiguous blocks: shard k1 holds X[k1 L + k2]. The
    inverse includes the 1/n scaling."""
    d = mesh.size
    if (1 << log_n) % d:
        raise ValueError("the mesh size must divide the domain")
    l = (1 << log_n) // d
    rows = []
    for g, dev, row in zip(mesh.shard_ids(), mesh.devices,
                           _shards(mesh, x_cyclic)):
        post = _dev_table("tw_inv" if inverse else "tw", log_n, d, g, dev,
                          lambda: _twiddle_post(log_n, d, inverse, g))
        rows.append(ntt_mod.transform(row.to(L.DTYPE).contiguous(), inverse,
                                      post=post))
    out = []
    for k1, dev, gathered in zip(mesh.shard_ids(), mesh.devices,
                                 mesh.all_gather(rows)):
        coeffs = _dev_table("dft_inv" if inverse else "dft", log_n, d, k1,
                            dev, lambda: _dft_column(d, inverse, k1, l))
        out.append(_fold_rows(FR.mont_mul(gathered.contiguous(), coeffs)))
    return out


_RELAYOUT = {}


def _relayout_idx(l: int, d: int, k: int, device):
    """(send, place) row indices of global shard k for blocked_to_cyclic:
    send[r, t] = ((r - k L) mod D) + D t, the rows it sends to shard r;
    place[j1, t] = base(j1) + t, where the rows it receives from shard j1
    land, base(j1) = (j1 L + ((k - j1 L) mod D) - k) / D."""
    key = (l, d, k, str(device))
    if key not in _RELAYOUT:
        t = np.arange(l // d)
        r = np.arange(d)
        send = ((r - k * l) % d)[:, None] + d * t[None, :]
        base = (r * l + (k - r * l) % d - k) // d
        place = base[:, None] + t[None, :]
        _RELAYOUT[key] = tuple(torch.from_numpy(a.reshape(-1)).to(device)
                               for a in (send, place))
    return _RELAYOUT[key]


def blocked_to_cyclic(mesh: Mesh, x_blocked) -> list:
    """Relayout of contiguous blocks (shard k1 holds X[k1 L + k2]) into
    cyclic residue rows (shard r holds X[r + D j]) with ONE all_to_all:
    k1's elements for r are k2 = ((r - k1 L) mod D) + D t, t < L/D, and
    land at r's rows base + t, base = (k1 L + ((r - k1 L) mod D) - r) / D
    (zkrollup/dist/mesh.py:blocked_to_cyclic)."""
    d = mesh.size
    shards = _shards(mesh, x_blocked)
    l = shards[0].shape[0]
    assert l % d == 0, "L must divide by device count"
    pieces = [row.index_select(0, _relayout_idx(l, d, k, dev)[0]).reshape(
        d, l // d, L.N_LIMBS)
        for k, dev, row in zip(mesh.shard_ids(), mesh.devices, shards)]
    out = []
    for r, dev, recv in zip(mesh.shard_ids(), mesh.devices,
                            mesh.all_to_all(pieces)):
        row = torch.empty((l, L.N_LIMBS), dtype=recv.dtype, device=dev)
        row.index_copy_(0, _relayout_idx(l, d, r, dev)[1],
                        recv.reshape(l, L.N_LIMBS))
        out.append(row)
    return out


# -- distributed quotient --------------------------------------------------------

def _coset_block(log_n: int, d: int, inverse: bool, g: int) -> np.ndarray:
    """Block g of the coset powers: g^i in Montgomery form (forward), or
    g^-i in plain form (inverse: that product also leaves the Montgomery
    domain)."""
    shift = ntt_mod.COSET_SHIFT
    if inverse:
        shift = pow(shift, FR.p - 2, FR.p)
    pw = ntt_mod._powers_host(log_n, shift, 1, not inverse)
    l = (1 << log_n) // d
    return pw[g * l:(g + 1) * l]


def sharded_quotient(mesh: Mesh, a_cyc, b_cyc, c_cyc, zinv_mont,
                     log_m: int) -> list:
    """Distributed h = (A B - C) / Z over the coset, every layout sharded:
    iNTT (four-step) to blocked coefficients, the coset scaling, the
    relayout (all_to_all) and the NTT to blocked coset evaluations, the
    pointwise step, then relayout, iNTT and the inverse coset scaling.
    Inputs: cyclic Montgomery-form domain evaluations (shards, or the
    (D, L, 16) tensors of cyclic_shard); zinv_mont one (16,) element.
    Returns the block shards of the PLAIN-form h coefficients (the MSM's
    scalar layout)."""
    d = mesh.size

    def scaled(kind, inverse, xs):
        return [FR.mont_mul(x, _dev_table(kind, log_m, d, g, dev,
                                          lambda: _coset_block(
                                              log_m, d, inverse, g)))
                for g, dev, x in zip(mesh.shard_ids(), mesh.devices, xs)]

    def to_coset_evals(x_cyc):
        coeffs = sharded_ntt(mesh, x_cyc, log_m, inverse=True)
        return sharded_ntt(mesh, blocked_to_cyclic(
            mesh, scaled("coset", False, coeffs)), log_m)

    ca, cb, cc = (to_coset_evals(x) for x in (a_cyc, b_cyc, c_cyc))
    h_cos = [FR.mont_mul(FR.sub(FR.mont_mul(a, b), c), zinv_mont.to(a.device))
             for a, b, c in zip(ca, cb, cc)]
    h = sharded_ntt(mesh, blocked_to_cyclic(mesh, h_cos), log_m,
                    inverse=True)
    return scaled("coset_inv_plain", True, h)


# -- distributed MSM ---------------------------------------------------------

def _tmap(fn, t):
    if isinstance(t, (tuple, list)):
        return type(t)(_tmap(fn, a) for a in t)
    return fn(t)


def _blocks(mesh: Mesh, t, n: int) -> list:
    """Rows of the nested tuple `t` of (n, ...) arrays or tensors -> this
    process's D-way contiguous blocks, each on its shard's device."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} shards")
    b = n // mesh.size
    return [_tmap(lambda a: _to(a[g * b:(g + 1) * b], dev), t)
            for g, dev in zip(mesh.shard_ids(), mesh.devices)]


def _fold_parts(curve, parts):
    """Fold the D gathered partials (leaves (D, ...)) on the safe add, the
    count padded with infinity to a power of two: leaves (...)."""
    n = curve.leaves(parts)[0].shape[0]
    n_pad = 1 << max((n - 1).bit_length(), 0)
    if n_pad != n:
        rows = curve.leaves(parts)[0].shape[1:-1]
        inf = curve.infinity((n_pad - n,) + tuple(rows),
                             curve.leaves(parts)[0].device)
        parts = curve.map(lambda a, i: torch.cat([a, i.to(a.dtype)]),
                          parts, inf)
        n = n_pad
    while n > 1:
        half = n // 2
        parts = curve.add(curve.map(lambda a: a[:half].contiguous(), parts),
                          curve.map(lambda a: a[half:n].contiguous(), parts))
        n = half
    return curve.map(lambda a: a[0], parts)


def sharded_window_sums(curve, mesh: Mesh, points_affine, scalars,
                        c: int = 12, n_bits: int = 256):
    """The window sums of the MSM of points_affine and scalars (every row,
    numpy arrays or tensors, n divisible by the mesh size): each shard runs
    msm.window_sums over its block of n / D rows (distinct=False), the D
    shards' window sums are gathered and folded on the safe add. Returns
    (leaves (W, 16) on this process's first device, c). The Horner of
    their sum is the sum of the shards' Horners, so the fold comes before
    the one combine (sharded_msm_g1, prove's host combine) in place of one
    combine a shard."""
    n = scalars.shape[0]
    parts = []
    for pts, sc in zip(_blocks(mesh, points_affine, n),
                       _blocks(mesh, scalars, n)):
        # every block has n / D rows: one clamped window c_eff
        wsum, c_eff = msm_mod.window_sums(curve, pts, sc, c=c,
                                          n_bits=n_bits)
        parts.append(torch.stack(curve.leaves(wsum)))
    gathered = mesh.gather(parts)                    # (D, leaves, W, 16)
    wsum = _fold_parts(curve, curve.from_leaves(
        [gathered[:, i].contiguous() for i in range(gathered.shape[1])]))
    return wsum, c_eff


def sharded_msm_g1(mesh: Mesh, points_affine, scalars, c: int = 12,
                   n_bits: int = 256):
    """points_affine (x, y, inf), scalars (n, 16) plain limbs below
    2^n_bits: numpy arrays or tensors of every row, n divisible by the
    mesh size. The sharded window sums, then one Horner launch
    (g1_horner). Returns one Jacobian point, (16,) leaves on this
    process's first device."""
    wsum, c = sharded_window_sums(G1, mesh, points_affine, scalars, c,
                                  n_bits)
    return G1.horner(wsum, c)


def sharded_msm_g2(mesh: Mesh, points_affine, scalars, c: int = 12,
                   n_bits: int = 256):
    """G2 variant of sharded_msm_g1: points ((x0, x1), (y0, y1), inf); one
    g2_horner launch."""
    wsum, c = sharded_window_sums(G2, mesh, points_affine, scalars, c,
                                  n_bits)
    return G2.horner(wsum, c)


# -- the whole distributed compute step of a proof ---------------------------

@contextlib.contextmanager
def _side_streams(mesh: Mesh, streams: dict):
    """Run the enclosed work on `streams` (one a CUDA device of the mesh,
    made on first use), each first waiting on the work its device's
    current stream has queued. No-op on the CPU."""
    cuda = sorted({d for d in mesh.devices if d.type == "cuda"}, key=str)
    if not cuda:
        yield
        return
    with contextlib.ExitStack() as stack:
        for d in cuda:
            s = streams.setdefault(d, torch.cuda.Stream(d))
            s.wait_stream(torch.cuda.current_stream(d))
            stack.enter_context(torch.cuda.stream(s))
        yield


def _record(t, streams):
    """Mark every tensor of `t` as in use by `streams` (record_stream), so
    that the caching allocator does not hand its memory out while they
    read it."""
    def rec(a):
        if isinstance(a, torch.Tensor) and a.device.type == "cuda":
            for d, s in streams.items():
                if d == a.device:
                    a.record_stream(s)
        return a
    _tmap(rec, t)


def pad_rows(a: torch.Tensor, n: int) -> torch.Tensor:
    """a with zero rows appended up to n rows (a itself if it has n or
    more)."""
    if a.shape[0] >= n:
        return a
    return torch.cat([a, a.new_zeros((n - a.shape[0],) + a.shape[1:])])


def distributed_prove_core(mesh: Mesh, a_cyc, b_cyc, c_cyc, zinv_mont,
                           log_m: int, g1_tables, g2_table, c: int = 12,
                           table_groups: int = 1):
    """One distributed Groth16 compute step: the sharded quotient, then the
    five sharded MSMs' window sums. g1_tables: {name: ((x, y, inf),
    scalars)} for a, b1, c and h, h's scalars None (the quotient's output,
    zero-padded to the table). g2_table: ((points), scalars) of b2.
    Returns (h block shards, {name: (window sums (W, 16), c)}), which the
    prover combines on the host as its single-device path does.

    table_groups > 1 splits the mesh into disjoint groups (submeshes) and
    deals the tables to them in turn; each group's MSMs run on CUDA
    streams of their own, each waiting first on the quotient's stream, so
    that the groups' work can overlap (the reference's asynchronous
    dispatch). The host synchronises before it returns. The results equal
    table_groups=1's, bit for bit."""
    h = sharded_quotient(mesh, a_cyc, b_cyc, c_cyc, zinv_mont, log_m)
    jobs = [(name, G1, pts, sc) for name, (pts, sc) in g1_tables.items()]
    if g2_table is not None:
        jobs.append(("b2", G2) + tuple(g2_table))
    if table_groups > 1:
        groups = submeshes(mesh, table_groups)
        where = [groups[i % table_groups] for i in range(len(jobs))]
    else:
        where = [mesh] * len(jobs)
    results = {}
    streams = [{} for _ in range(table_groups)]
    for i, (name, curve, pts, sc) in enumerate(jobs):
        if sc is None:      # h's scalars, zero rows under the padding
            sc = pad_rows(unblock(mesh.gather(h)), pts[2].shape[0])
        if table_groups == 1:
            results[name] = sharded_window_sums(curve, mesh, pts, sc, c)
            continue
        st = streams[i % table_groups]
        with _side_streams(where[i], st):
            _record((pts, sc), st)
            results[name] = sharded_window_sums(curve, where[i], pts, sc, c)
    if table_groups > 1:
        for st in streams:
            for d, s in st.items():
                torch.cuda.current_stream(d).wait_stream(s)
        _record(results, {d: torch.cuda.current_stream(d)
                          for st in streams for d in st})
        for d in {d for st in streams for d in st}:
            torch.cuda.synchronize(d)
    return h, results
