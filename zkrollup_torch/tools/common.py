"""What the measurement tools share: the device an entry point runs on, a
device synchronise, first-call and steady timing, seeded scalars, distinct
G1 points made by the port's fixed base (cached under build/), and the
native engine's MSM of a table as the result a tool is held against.

An entry point runs on the card unless its caller asks for the CPU
(`--device cpu`); asked for a CUDA device that is not there, it raises.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..fields import limbs as L
from ..native import engine

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(ROOT, "build")


def device(name: str) -> torch.device:
    """The torch device `name`; raises when it is a CUDA device and no
    card is there (no fallback to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for --device {name}: pass "
                           "--device cpu to run on the CPU")
    return dev


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev: torch.device, reps: int = 3):
    """(the last result, seconds of the first call, mean seconds of `reps`
    steady calls), each call ended by a device synchronise."""
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
        sync(dev)
    return out, first, (time.perf_counter() - t0) / max(reps, 1)


def random_scalars(n: int, seed: int) -> np.ndarray:
    """(n, 16) uint32 plain limbs of seeded scalars below 2^254 < r (the
    reference tools' top limb masked with 0x2FFF)."""
    sc = np.random.RandomState(seed).randint(
        0, 1 << 16, size=(n, L.N_LIMBS)).astype(np.uint32)
    sc[:, L.N_LIMBS - 1] &= 0x2FFF
    return sc


def scalar_bytes(sc: np.ndarray) -> bytes:
    """(n, 16) canonical plain limbs -> the engine's 32-byte little-endian
    scalars."""
    return np.ascontiguousarray(np.asarray(sc).astype("<u2")).tobytes()


def distinct_points(n: int, dev: torch.device):
    """n distinct affine G1 points (x, y, inf) as numpy Montgomery limbs:
    k_i * G for distinct seeded k_i below 2^62, by the port's fixed base
    (msm/fixed_base.py:g1_points_from_scalars) on `dev`; cached in
    build/msm_points/ by n. The key tables' distribution, not a few points
    tiled."""
    from ..msm.fixed_base import g1_points_from_scalars
    path = os.path.join(BUILD_DIR, "msm_points", f"g1_{n}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["x"], z["y"], z["inf"]
    rng = np.random.RandomState(42)
    ks = np.unique(rng.randint(1, 1 << 62, size=2 * n, dtype=np.int64))
    ks = rng.permutation(ks)[:n]
    if ks.shape[0] != n:
        raise RuntimeError(f"{n} distinct scalars not drawn")
    x, y, inf = g1_points_from_scalars([int(k) for k in ks], device=dev)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.npz"
    np.savez(tmp, x=x, y=y, inf=inf)
    os.replace(tmp, path)
    return x, y, inf


def on_device(points, dev: torch.device):
    """(x, y, inf) numpy arrays -> int32 limb tensors and a bool mask."""
    x, y, inf = points
    return (L.to_device(x, dev), L.to_device(y, dev),
            torch.from_numpy(np.asarray(inf, bool)).to(dev))


def engine_msm(points, sc: np.ndarray):
    """sum_i sc_i P_i by the native engine's Pippenger: affine (x, y) ints
    or None."""
    if not engine.available():
        raise RuntimeError("the native engine did not build (g++, "
                           "native/src)")
    return engine.g1_msm_pip(engine.pack_g1_table_mont(points),
                             scalar_bytes(sc), sc.shape[0])


def jacobian_affine(jac):
    """A G1 Jacobian point with (16,) Montgomery leaves -> affine | None."""
    from ..curve import g1
    return g1.to_affine_host([a.reshape(1, L.N_LIMBS) for a in jac])[0]


def device_name(dev: torch.device) -> str:
    """The card's name, or "cpu"."""
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


DEMO_KEY = os.path.join(BUILD_DIR, "keys", "tx_2_6.npz")
WEI = 10 ** 18
PRIV_A = 1234567890123456789
PRIV_B = 9876543210987654321


def demo_batch(dev, prover=None):
    """The (2,6) demo batch as the reference's tools/prove_breakdown.py
    makes it: A and B deposit 1 ETH each, A's two signed sends (0.1 ETH,
    fee 0.01; 0.3 ETH, fee 0.02) go through the operator's /send handler,
    and the batch is prepared from the queue. Returns (prover, prepared
    batch); the prover (a TxProver of BatchProcessTx(2,6) on `dev`
    unless one is given, whose configuration then holds) takes its key
    from DEMO_KEY, made by setup on `dev` and saved there when missing or
    stale."""
    from ..chain.simulator import RollUpContract
    from ..config import RollupConfig
    from ..operator.prover import TxProver
    from ..operator.queue import TxQueue
    from ..operator.service import OperatorApp
    from ..operator.state import OperatorState
    from ..ref import eddsa
    from ..witness.assembler import Transaction, format_tx

    if prover is None:
        prover = TxProver(RollupConfig(), key_path=DEMO_KEY,
                          setup_seed=b"e2e", device=dev)
    cfg = prover.cfg
    contract = RollUpContract(cfg, tx_vk=None, withdraw_vk=None)
    state, queue = OperatorState(cfg), TxQueue()
    app = OperatorApp(cfg, state, queue, contract, None)
    for priv in (PRIV_A, PRIV_B):
        pub = eddsa.gen_public_key(priv)
        contract.deposit(pub[0], pub[1], WEI)
    app.sync_chain()
    for amount, fee, nonce in ((WEI // 10, WEI // 100, 1),
                               (3 * WEI // 10, 2 * WEI // 100, 2)):
        tx = Transaction(0, 1, amount, fee, nonce)
        tx.signature = eddsa.sign(PRIV_A, format_tx(tx))
        resp = app.post_send({
            "from": 0, "to": 1, "amount": str(amount), "fee": str(fee),
            "nonce": nonce,
            "signature": {"R8": [str(tx.signature.R8[0]),
                                 str(tx.signature.R8[1])],
                          "S": str(tx.signature.S)}})
        if "error" in resp:
            raise RuntimeError(f"/send refused the demo transfer: {resp}")
    prep = prover.prepare_batch(state.load_tree(),
                                queue.peek_batch(cfg.batch_size))
    return prover, prep
