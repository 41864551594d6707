"""The frozen correlation-id attribution and the whole-window rule on a
canned Chrome trace: kernels go to the innermost label open on the
launching thread, the lead-in is left out, idle stretches are cut where
the innermost host label changes and take that label, and a lost kernel
after the lead-in is seen."""

import json

from rollbench import trace


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": tid,
         "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def canned(drop=None):
    ev = []
    # lead-in: two spin kernels
    for k in (1, 2):
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", k, 1, corr=k))
        ev.append(_x("kernel", "spin_kernel(long)", 10 + k, 1, tid=0,
                     corr=k))
    ev.append(_x("user_annotation", "rollbench.window", 100, 900))
    ev.append(_x("user_annotation", "rollbench.call", 110, 800))
    ev.append(_x("user_annotation", "groth16.msm_g1", 120, 100))
    # launched inside msm_g1 on tid 1
    ev.append(_x("cuda_runtime", "cudaLaunchKernel", 130, 2, corr=3))
    ev.append(_x("kernel", "void g1_add_kernel<Fq>(int*, long)", 200, 50,
                 tid=0, corr=3))
    # launched inside rollbench.call only
    ev.append(_x("cuda_runtime", "cudaLaunchKernel", 300, 2, corr=4))
    ev.append(_x("kernel", "void at::native::index_select<int>(...)", 400,
                 100, tid=0, corr=4))
    # a copy launched on another thread under no label
    ev.append(_x("cuda_runtime", "cudaMemcpyAsync", 305, 2, tid=2, corr=5))
    ev.append(_x("gpu_memcpy", "Memcpy DtoH", 450, 100, tid=0, corr=5))
    if drop is not None:
        ev = [e for e in ev if not (e["cat"] == "kernel"
                                    and e["args"]["correlation"] == drop)]
    return ev


def test_attribution_and_gaps():
    ev = trace.parse_chrome(json.dumps({"traceEvents": canned()}))
    s = trace.summarize(ev, calls=1, wall_s=0.0009, lead=2)
    assert s.label_us == {"groth16.msm_g1": 50, "rollbench.call": 100,
                          trace.NO_LABEL: 100}
    # busy: [200, 250] and [400, 550]
    assert abs(s.busy_s - 200e-6) < 1e-12
    assert s.op_us["groth16.msm_g1:g1_add_kernel"] == 50
    assert s.op_us["rollbench.call:at::native::index_select"] == 100
    # idle stretches, cut where the innermost host label changes
    gaps = sorted((round(g * 1e6), label) for g, label in s.gaps)
    assert gaps == [(10, "rollbench.call"), (10, "rollbench.window"),
                    (80, "groth16.msm_g1"), (90, "rollbench.window"),
                    (150, "rollbench.call"), (360, "rollbench.call")]


def test_lost_kernel_after_the_lead_in():
    assert trace.lost_launches(canned(), lead=2) == 0
    assert trace.lost_launches(canned(drop=1), lead=2) == 0
    assert trace.lost_launches(canned(drop=3), lead=2) == 1


def test_short_name():
    assert trace.short_name("void ns::k<A<B>, 3>(int*, long)") == "ns::k"
