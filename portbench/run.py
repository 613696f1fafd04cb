"""Run one cell of the port's benchmark once, on the card, and print its
result as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

One process, in this order: the cell's weights and adapters made on the
card from ``--seed``; the port's ``RealModelExecutor`` built from them;
a prefill at each of a few of the mix's own lengths to warm up; the
window of ``--seconds``; the comparison with the plain reference.  With
``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones, read from a device trace of the window.

A cell is found by name in ``BENCHMARK.json``; its configuration, mix,
limits, loop and metric readers are files under this directory
(``spec.py``).  Without a card, or with fewer than the cell asks for,
the run fails; it never falls back to the CPU.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
# the program's build and kernel caches, at fixed paths in the checkout
os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "portbench"
                                          / "kernels")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "portbench" / "triton")

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARM_QUANTILES = (0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0)


def forbidden_modules():
    """Top-level names of loaded modules that the port must not load."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def warm_lengths(lengths):
    """The prompt lengths set-up prefills once each: a few of the mix's."""
    import numpy as np
    return sorted({int(np.quantile(lengths, q, method="nearest"))
                   for q in WARM_QUANTILES})


def port_executor(cfg, params, bundles, sv, dev):
    """The system under test: the port's executor over the cell's weights
    and adapters."""
    from repro_torch.serving.real_executor import RealModelExecutor
    return RealModelExecutor(cfg, params, bundles, sv["mode"],
                             max_batch=sv["slots"], s_max=sv["s_max"],
                             decode_path=sv["decode_path"], device=dev)


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float = T_START, executor=port_executor):
    """One run of ``cell`` (``spec.Cell``); returns its result line, the
    compared numbers last (``checks``).  ``executor(cfg, params, bundles,
    serving, device)`` builds what the window drives (``control.py`` puts
    the control in the program's place)."""
    import numpy as np
    import torch

    from portbench import check, devtrace, flops, generate, spec, weights
    from repro_torch.models import transformer as tf
    from repro_torch.serving.request import Request  # warm-up requests

    # one thread for torch's own CPU work: the host drives the card from
    # one thread, and idle pool threads only take cores from it
    torch.set_num_threads(1)
    phases = {"imports": time.perf_counter() - t_start}
    conf, traffic = cell.config, cell.traffic
    sv = conf["serving"]
    cfg = spec.port_config(conf)
    rc = spec.reference_config(conf)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    loop = spec.load_module(HERE / "loops" / f"{traffic['loop']}.py")

    sched = generate.schedule(traffic)
    n_need = len(sched.lengths)
    if traffic["arrival"] != "backlog":
        n_need = int(np.searchsorted(sched.due_s, seconds, side="right"))
    inputs = generate.Inputs(traffic, seed, sv["adapters"], cfg.vocab_size)
    drawn = [inputs.request(i, sched.lengths[i]) for i in range(n_need)]
    prompts = [t for t, _ in drawn]
    adapters = np.array([a for _, a in drawn], dtype=np.int64)
    phases["inputs"] = time.perf_counter() - t_start

    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    params = weights.model_weights(tf.model_defs(cfg), cfg, g, dev)
    bundles = weights.adapter_bundles(cfg, sv, g, dev)
    ex = executor(cfg, params, bundles, sv, dev)
    if cuda:
        torch.cuda.synchronize(dev)
    phases["weights_and_executor"] = time.perf_counter() - t_start

    warm_rng = np.random.default_rng([int(seed), 0x3A])
    for k, L in enumerate(warm_lengths(sched.lengths[:n_need])):
        rid = -1 - k
        ex.prefill_request(Request(rid=rid, adapter_id=k % sv["adapters"],
                                   prompt_len=L, max_new_tokens=1),
                           warm_rng.integers(0, cfg.vocab_size, L))
        ex.release(rid)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    # what set-up made stays alive through the window: keep the collector
    # from walking it again and again in there
    gc.collect()
    gc.freeze()

    with devtrace.traced(trace) as tr:
        served = loop.serve(ex, sched, prompts, adapters, seconds,
                            traffic["arrival"],
                            np.random.default_rng([int(seed), 0x401D]))
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    summary = None
    if trace:
        summary = devtrace.summarize(tr.events, served["t0_ns"],
                                     served["t1_ns"], served["spans"])
        del tr

    gc.unfreeze()
    t_check = time.perf_counter()
    kv = check.export_held(ex, served)
    cmp = check.sample(served, seed)
    del ex
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    nums = check.compare(params, rc, bundles, prompts, adapters, cmp, kv,
                         dev)

    check_s = time.perf_counter() - t_check
    for r in served["requests"]:
        r["flops"] = flops.prefill_flops(rc, conf["intermediate_size"],
                                         conf["vocab_size"], sv,
                                         r["tokens"])
    rec = {"setup_s": setup_s,
           "window_s": served["window_s"],
           "requests": served["requests"], "trace": summary,
           "peak_flops": flops.PEAK_FLOPS}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        reader = spec.load_module(HERE / "metrics" / f"{m['name']}.py")
        value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    checks = {k: {"value": nums[k], "limit": float(v["limit"])}
              for k, v in cell.limits.items()}
    checks["missing"] = {"value": served["missing"], "limit": 0}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct),
              "attempted": len(served["requests"]),
              "failed": served["missing"], "metrics": metrics,
              "device": device_info}
    if trace and summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    # set-up's phases, each as seconds since the process began, and the
    # seconds of the comparison after the window
    result["setup_phases_s"] = phases
    result["check_s"] = check_s
    result["checks"] = checks
    return result


def _finite(obj):
    """``obj`` with every non-finite number as null (strict JSON)."""
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import spec
    cell = spec.load_cell(args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"{have} available", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"the process loaded {bad} after the window", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
