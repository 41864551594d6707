"""zkrollup_torch.dist (the mesh, the sharded NTT, MSM and quotient, and
prove(mesh=)) against zkrollup.dist and single-device results, on virtual
CPU meshes: one process driving D shards on the CPU, and two processes
over gloo (tools/multihost_sim.py).

Inputs come from numpy seeds; every comparison is exact: limbs bit for
bit, points as affine points, proofs byte for byte at pinned (r, s).
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zkrollup.dist import mesh as jmesh
from zkrollup.groth16 import prove as jprove_fn
from zkrollup.groth16.keys import ProvingKey as JProvingKey
from zkrollup.native import engine as jengine
from zkrollup.ntt import ntt as jntt
from zkrollup.r1cs.builder import Builder as JBuilder
from zkrollup_torch.curve import g1 as g1m, g2 as g2m
from zkrollup_torch.dist import mesh as dm
from zkrollup_torch.fields import limbs as L
from zkrollup_torch.fields.mont import FR
from zkrollup_torch.groth16 import prove as P
from zkrollup_torch.groth16.setup import setup_host
from zkrollup_torch.groth16.verify import verify
from zkrollup_torch.ntt import ntt
from zkrollup_torch.r1cs.builder import Builder
from zkrollup_torch.ref import bn254 as ref

# One intra-op thread per process: the suite runs in several worker
# processes, whose torch thread pools would otherwise fight for the cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 8
LOG_N = 8          # 256 rows: L = 32, L % D == 0
N = 1 << LOG_N


def _mont(seed, n=N):
    rng = np.random.RandomState(seed)
    return FR.to_mont_host([int(v) for v in rng.randint(1, 1 << 30, size=n)])


@pytest.fixture(scope="module")
def mesh():
    return dm.make_mesh(D, device="cpu")


@pytest.fixture(scope="module")
def x_np():
    return _mont(11)


def test_make_mesh_needs_a_card_or_a_device():
    """make_mesh() takes the visible CUDA devices and never drops to the
    CPU; a virtual mesh names its device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dm.make_mesh()
    m = dm.make_mesh(4, device="cpu")
    assert (m.size, m.local, m.first, m.staged) == (4, 4, 0, False)
    assert m.devices == (torch.device("cpu"),) * 4


_MESH_CHILD = """
import json, sys
import torch
import torch.distributed as dist
from zkrollup_torch.dist import mesh as dm
from zkrollup_torch.dist.launch import init_distributed
rank, port = int(sys.argv[1]), int(sys.argv[2])
init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo")
torch.cuda.device_count = lambda: 4     # four visible cards (none touched)
out = {}
for name, kw in (("default", {}), ("one", {"n_devices": 1}),
                 ("hosts", {"n_devices": 2, "local_rank": 0})):
    m = dm.make_mesh(**kw)
    out[name] = [[str(d) for d in m.devices], m.size, m.first, m.staged]
try:
    dm.make_mesh(3)
    out["three"] = "taken"
except ValueError:
    out["three"] = "refused"
print(json.dumps(out), flush=True)
dist.destroy_process_group()
"""


def test_make_mesh_gives_each_process_its_own_cards():
    """Under a two-process gloo group make_mesh() with no device gives each
    rank its own share of the visible cards (NCCL refuses two ranks on one
    card), local_rank picks the share on hosts of their own, and cards past
    the visible ones are refused."""
    import json
    from zkrollup_torch.tools.multihost_sim import _free_port
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MESH_CHILD, str(r), str(port)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1")) for r in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    for r, got in enumerate(outs):
        assert got["default"] == [[f"cuda:{2 * r}", f"cuda:{2 * r + 1}"],
                                  4, 2 * r, True]
        assert got["one"] == [[f"cuda:{r}"], 2, r, True]
        assert got["hosts"] == [["cuda:0", "cuda:1"], 4, 2 * r, True]
    assert [o["three"] for o in outs] == ["taken", "refused"]


def test_blocked_to_cyclic_matches_reference(mesh, x_np):
    """The relayout against zkrollup.dist.mesh.blocked_to_cyclic on the
    conftest's 8 virtual JAX devices (the reference's TestRelayout)."""
    x = L.to_device(x_np, "cpu")
    got = dm.blocked_to_cyclic(mesh, dm.block_shard(x, D))
    want = np.asarray(jmesh.blocked_to_cyclic(
        jmesh.make_mesh(D), jmesh.block_shard(jnp.asarray(x_np), D)))
    assert np.array_equal(torch.stack(got).numpy().astype(np.uint32), want)
    assert all(torch.equal(a, b) for a, b in zip(got, dm.cyclic_shard(x, D)))


def test_sharded_ntt_matches_reference_and_host_ints(mesh, x_np):
    x = L.to_device(x_np, "cpu")
    fwd = dm.sharded_ntt(mesh, dm.cyclic_shard(x, D), LOG_N)
    got = dm.unblock(fwd)
    jx = jnp.asarray(x_np)
    assert np.array_equal(got.numpy().astype(np.uint32),
                          np.asarray(jntt.ntt_mont(jx)))
    vals = FR.from_mont_host(x_np)
    w = ntt.domain_root(LOG_N)
    want = [sum(v * pow(w, i * j, FR.p) for j, v in enumerate(vals)) % FR.p
            for i in range(0, N, 37)]
    assert FR.from_mont_host(got.numpy()[::37]) == want
    # the inverse round trip: intt_mont(ntt_mont(x)) = x
    back = dm.sharded_ntt(mesh, dm.blocked_to_cyclic(mesh, fwd), LOG_N,
                          inverse=True)
    assert torch.equal(dm.unblock(back), x)


@pytest.mark.parametrize("curve", ["g1", "g2"])
@pytest.mark.parametrize("d", [8, 6])
def test_sharded_msm_matches_ref(curve, d):
    """D = 6 pads the fold's 6 partials with infinity to 8."""
    rng = np.random.RandomState(5 if curve == "g1" else 6)
    n = d * (8 if curve == "g1" else 4)
    ks = [int(v) for v in rng.randint(1, 1 << 20, size=n)]
    ss = [int(v) for v in rng.randint(1, 1 << 20, size=n)]
    m = dm.make_mesh(d, device="cpu")
    mul, gen, mod, fn = ((ref.g1_mul, ref.G1_GEN, g1m, dm.sharded_msm_g1)
                         if curve == "g1" else
                         (ref.g2_mul, ref.G2_GEN, g2m, dm.sharded_msm_g2))
    res = fn(m, mod.pack_affine_host([mul(gen, k) for k in ks]),
             L.ints_to_limbs(ss), c=4, n_bits=20)
    curve_ = dm.G1 if curve == "g1" else dm.G2
    got = mod.to_affine_host(curve_.map(lambda a: a.reshape(1, 16), res))[0]
    assert got == mul(gen, sum(k * s for k, s in zip(ks, ss)))


def test_sharded_quotient_matches_single_device(mesh):
    a, b, c = (L.to_device(_mont(s), "cpu") for s in (7, 8, 9))
    z_coset = (pow(ntt.COSET_SHIFT, N, FR.p) - 1) % FR.p
    zinv = FR.const_mont(pow(z_coset, FR.p - 2, FR.p), "cpu")
    got = dm.sharded_quotient(mesh, *(dm.cyclic_shard(e, D)
                                      for e in (a, b, c)), zinv, LOG_N)
    assert torch.equal(dm.unblock(got), P._quotient_plain(a, b, c, zinv))


def _fake_pk(n_vars=117114, n_public=75, m=1 << 17):
    """The (2,6) key's table shapes, zero tables (no curve math)."""
    z1 = np.zeros((n_vars, 16), np.uint32)
    inf = np.ones((n_vars, 1), bool)
    g1 = (z1, z1, inf)
    h = (np.zeros((m - 1, 16), np.uint32),) * 2 + (np.ones((m - 1, 1), bool),)
    zc = np.zeros((n_vars - n_public, 16), np.uint32)
    c = (zc, zc, np.ones((n_vars - n_public, 1), bool))
    return types.SimpleNamespace(domain_size=m, n_vars=n_vars,
                                 n_public=n_public, a_g1=g1, b1_g1=g1,
                                 c_g1=c, h_g1=h, b2_g2=((z1, z1), (z1, z1), inf))


@pytest.mark.parametrize("d", [6, 8, 12])
def test_dist_tables_pad_at_production_shapes(d):
    """tests/test_dist.py::TestDistTablePadding on the port's tables: one
    size divisible by the mesh, at least the domain and the variables,
    padding rows infinity."""
    pk = _fake_pk()
    tbl = P._dist_tables(pk, d, "cpu")
    pad_to = tbl["pad_to"]
    assert pad_to % d == 0 and pad_to >= max(pk.domain_size, pk.n_vars)
    assert pad_to == -(-(1 << 17) // d) * d
    for key in ("a", "b1", "c", "h"):
        x, y, inf = tbl[key]
        assert x.shape == y.shape == (pad_to, 16) and inf.shape == (pad_to, 1)
        assert bool(inf.all())
    (bx0, bx1), (by0, by1), binf = tbl["b2"]
    assert bx0.shape[0] == by1.shape[0] == binf.shape[0] == pad_to
    assert P._dist_tables(pk, d, "cpu") is tbl          # cached on the key


def squarings(builder):
    """The reference's toy circuit (tests/test_dist.py): 40 squarings."""
    bld = builder(check=True)
    out = bld.alloc_output_deferred()
    x = bld.alloc_public_input(7)
    t = x
    for _ in range(40):
        t = bld.mul(t, t) + x
    bld.bind_output(out, t)
    return bld


@pytest.fixture(scope="module")
def mesh_proofs():
    bld = squarings(Builder)
    r1cs, w = bld.r1cs(), bld.witness()
    pk = setup_host(r1cs, seed=b"dist-prove")
    m4 = dm.make_mesh(4, device="cpu")
    proofs = {"mesh": P.prove(pk, r1cs, w, r=3, s=5, mesh=m4),
              "device": P.prove(pk, r1cs, w, r=3, s=5, device="cpu"),
              "host": P.prove_host(pk, r1cs, w, r=3, s=5)}
    return bld, pk, {k: (p.a, p.b, p.c) for k, p in proofs.items()}


@pytest.mark.parametrize("other", ["device", "host"])
def test_mesh_proof_equals(mesh_proofs, other):
    """prove(mesh=make_mesh(4, device="cpu")) against the single-device
    proof and the native engine's, at r = 3, s = 5. table_groups=2 is held
    to table_groups=1 on the core below; the whole proof with groups, where
    each group runs on CUDA streams of its own, is a card test."""
    _, _, proofs = mesh_proofs
    assert proofs["mesh"] == proofs[other]


def test_mesh_proof_verifies_and_equals_reference(mesh_proofs):
    bld, pk, proofs = mesh_proofs
    from zkrollup_torch.groth16.keys import Proof
    assert verify(pk.vk, Proof(*proofs["mesh"]), bld.public_signals())
    if not jengine.available():
        pytest.skip("the JAX package's native engine is not built")
    jbld = squarings(JBuilder)
    jpk = JProvingKey(**{k: v for k, v in vars(pk).items()
                         if not k.startswith("_")})
    want = jprove_fn(jpk, jbld.r1cs(), jbld.witness(), r=3, s=5,
                     backend="host")
    assert proofs["mesh"] == (want.a, want.b, want.c)


def _combine_host(wsum, c):
    """sum over windows i of 2^(c i) W_i (G1), in host ints."""
    acc = None
    for i, p in enumerate(g1m.to_affine_host(wsum)):
        if p is not None:
            acc = ref.g1_add(acc, ref.g1_mul(p, 1 << (c * i)))
    return acc


def test_table_groups_deal_tables_like_one_group():
    """distributed_prove_core with table_groups=2 (a dealt to one half of
    a 4-shard mesh, h to the other) gives table_groups=1's quotient limb
    for limb and the same MSMs, each the reference's (host ints; the window
    differs, since a half's blocks are twice as long). Tables of 16 rows
    with an infinity row and a duplicate point, as in the key's padded
    tables; h's scalars are the quotient's output. The G2 table's dealing
    is held on the card, in the whole proof with groups."""
    log_m, n = 4, 16
    m4 = dm.make_mesh(4, device="cpu")
    rng = np.random.RandomState(21)
    ks = [int(v) for v in rng.randint(1, 1 << 20, size=n)]
    ks[5] = ks[4]                                   # a duplicate point
    ss = [int(v) for v in rng.randint(1, 1 << 20, size=n)]
    ss[9] = 0
    g1_pts = [ref.g1_mul(ref.G1_GEN, k) for k in ks]
    g1_pts[9] = None                                # an infinity row
    sc = L.to_device(L.ints_to_limbs(ss), "cpu")
    abc = [dm.cyclic_shard(L.to_device(_mont(s, n), "cpu"), 4)
           for s in (7, 8, 9)]
    z_coset = (pow(ntt.COSET_SHIFT, n, FR.p) - 1) % FR.p
    zinv = FR.const_mont(pow(z_coset, FR.p - 2, FR.p), "cpu")
    g1_tbl = g1m.pack_affine_host(g1_pts)
    runs = [dm.distributed_prove_core(
        m4, *abc, zinv, log_m,
        g1_tables={"a": (g1_tbl, sc), "h": (g1_tbl, None)},
        g2_table=None, c=4, table_groups=groups) for groups in (1, 2)]
    (h1, res1), (h2, res2) = runs
    assert all(torch.equal(a, b) for a, b in zip(h1, h2))
    hs = FR.from_mont_host(FR.to_mont(dm.unblock(h1)).numpy())
    want = {"a": ref.g1_mul(ref.G1_GEN, sum(
                k * s for i, (k, s) in enumerate(zip(ks, ss)) if i != 9)),
            "h": ref.g1_mul(ref.G1_GEN, sum(
                k * s for i, (k, s) in enumerate(zip(ks, hs)) if i != 9))}
    for res in (res1, res2):
        assert res.keys() == want.keys()
        for name, (wsum, c) in res.items():
            assert _combine_host(wsum, c) == want[name], name


def test_prove_takes_device_or_mesh(mesh_proofs):
    bld, pk, _ = mesh_proofs
    r1cs, w = bld.r1cs(), bld.witness()
    m = dm.make_mesh(2, device="cpu")
    for kw in ({}, {"device": "cpu", "mesh": m},
               {"device": "cpu", "table_groups": 2}):
        with pytest.raises(ValueError):
            P.prove(pk, r1cs, w, r=3, s=5, **kw)


def test_multihost_sim_on_gloo():
    """Two processes over the loopback, two CPU shards each."""
    res = subprocess.run(
        [sys.executable, "-m", "zkrollup_torch.tools.multihost_sim",
         "--device", "cpu", "--backend", "gloo"], cwd=ROOT,
        capture_output=True, text=True, timeout=240,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "MULTIHOST OK" in res.stdout
    assert res.stdout.count("verified on cpu (gloo") == 2


# -- against the reference's sharded programs (shard_map compiles: slow) -----

@pytest.mark.slow
def test_sharded_ntt_and_quotient_match_reference_programs(mesh, x_np):
    jm = jmesh.make_mesh(D)
    x = L.to_device(x_np, "cpu")
    got = dm.unblock(dm.sharded_ntt(mesh, dm.cyclic_shard(x, D), LOG_N))
    want = jmesh.unblock(jmesh.sharded_ntt(
        jm, jmesh.cyclic_shard(jnp.asarray(x_np), D), LOG_N))
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))
    abc = [_mont(s) for s in (7, 8, 9)]
    z_coset = (pow(ntt.COSET_SHIFT, N, FR.p) - 1) % FR.p
    zinv = pow(z_coset, FR.p - 2, FR.p)
    got = dm.unblock(dm.sharded_quotient(
        mesh, *(dm.cyclic_shard(L.to_device(e, "cpu"), D) for e in abc),
        FR.const_mont(zinv, "cpu"), LOG_N))
    from zkrollup.fields.mont import FR as JFR
    want = jmesh.unblock(jmesh.sharded_quotient(
        jm, *(jmesh.cyclic_shard(jnp.asarray(e), D) for e in abc),
        JFR.const_mont(zinv), LOG_N))
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))
