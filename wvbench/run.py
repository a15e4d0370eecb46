"""Run one cell of BENCHMARK.json once and print one JSON line.

    python3 wvbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--control 0|1]

Set-up (imports and the CUDA context, the cell's kernel libraries, the
inputs made from the seed in a worker pool, warm-up calls) is timed from
the process's start; then the cell's calls run back to back, one caller,
for `--seconds`; then the outputs are checked against the plain reference
(check.py). `--trace 0` reports the cell's end-to-end metrics (with a
trace of the device's work alone where one of them is read from it),
`--trace 1` its per-layer metrics from a torch.profiler trace and the
program's stage timers. `--control 1` runs the configuration's control,
which must come out not correct. Every compiled artifact stays under
`build/` in the checkout. The run refuses, printing no result, without
enough CUDA devices, without the program's native host library, when a
kernel the cell needs never launched, or when jax, jaxlib, flax or wvpk
is loaded.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import resource
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ in ("__main__", "__mp_main__"):
    # run as a script: the checkout's root, not wvbench/, heads the path
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
            os.path.abspath(__file__)):
        sys.path[0] = ROOT
    elif ROOT not in sys.path:
        sys.path.insert(0, ROOT)

BANNED = ("jax", "jaxlib", "flax", "wvpk")


def process_start() -> float:
    """The epoch time this process started (Linux /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or wvpk,
    compared whole (wvpk_torch is not wvpk)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def cache_dirs(root: str = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = os.path.join(root, "build")
    os.environ["WVPK_NATIVE_CACHE"] = os.path.join(build, "wvpk_native")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")


def power_limit_w() -> float | None:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _counter(path: str) -> int:
    import importlib
    mod, fn = path.split(":")
    return int(getattr(importlib.import_module(mod), fn).launches)


def run_cell(cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda:0", guards: bool = True,
             control: bool = False, t_start: float | None = None,
             workers: int | None = None, log=sys.stderr):
    """Run `cell` (manifest.Cell) once. Returns (exit code, result dict or
    None). `guards` makes the device checks of a real run; a test runs
    the rest on the CPU with guards off."""
    import multiprocessing

    import torch

    from wvbench import check, inputs, manifest, ops, tracing
    from wvbench.gen import native as gen_native
    from wvbench.gen.synth import rng_for
    from wvpk_torch import trace as port_trace

    t_start = time.time() if t_start is None else t_start
    config, traffic = cell.config, cell.traffic
    op = traffic["op"]
    split = {}
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev)
        torch.cuda.synchronize()
    split["import_ctx"] = time.time() - t_start

    t = time.time()
    if guards:
        from wvpk_torch import _build, native
        sources = config["cuda_sources"][op]
        _build.build_all(sources)
        for name in sources:
            _build.load(name)
        if native.get_lib() is None:
            print("refused: the program's native host library did not load",
                  file=log)
            return 6, None
    gen_native.lib()
    split["libraries"] = time.time() - t

    t = time.time()
    n_workers = workers or min(8, os.cpu_count() or 1)
    pool = multiprocessing.get_context("spawn").Pool(n_workers)
    try:
        files = inputs.make_pool(seed, config, traffic, pool,
                                 encode=op == "decode")
        split["inputs"] = time.time() - t
        pcm_bytes = sum(f.pcm.nbytes for f in files)
        print(f"inputs: {len(files)} files, "
              f"{sum(f.frames for f in files)} frames"
              + (f", .wv {100 * sum(len(f.wv) for f in files) / pcm_bytes:.2f}"
                 "% of the PCM" if op == "decode" else ""), file=log)

        per_call = traffic["files_per_call"]
        options = config.get("encode_options", {})

        def call(idx, spans):
            fs = [files[i] for i in idx]
            if op == "decode":
                return ops.decode(fs, device, spans)
            return ops.encode(fs, device, spans, options), 0

        t = time.time()
        warm_spans = tracing.Spans(record=False)
        warm = ops.plan(rng_for(seed, inputs.STREAM_WARM), len(files),
                        per_call)
        for _ in range(traffic["warm_calls"]):
            call(next(warm), warm_spans)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        split["warmup"] = time.time() - t
        split["warmup_parse"] = warm_spans.seconds.get("parse", 0.0)

        counters = config["launch_counters"][op] if guards else []
        before = {c: _counter(c) for c in counters}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        spans = tracing.Spans(record=trace)
        stages: dict[str, float] = {}
        rec = check.Record()
        keep_rng = rng_for(seed, inputs.STREAM_CHECK, 1)
        plan = ops.plan(rng_for(seed, inputs.STREAM_CALLS), len(files),
                        per_call)
        # traced: host and device; untraced, a cell with an end-to-end
        # metric from the device trace records the device's work alone
        acts = []
        if trace:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        if dev.type == "cuda" and (trace or any(
                m["source"] == "device_trace" for m in cell.end_to_end)):
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = None
        if acts:
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        print("setup split (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in split.items()), file=log)
        setup_s = time.time() - t_start
        latencies, frames, nbytes, failed = [], 0, 0, 0
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        w0 = time.perf_counter()
        with torch.profiler.record_function(tracing.WINDOW) if trace \
                else contextlib.nullcontext():
            while True:
                idx = next(plan)
                c0 = time.perf_counter()
                if trace:
                    with port_trace.collect() as sink:
                        outs, bad = call(idx, spans)
                    for k, v in sink.items():
                        stages[k] = stages.get(k, 0.0) + v
                else:
                    outs, bad = call(idx, spans)
                c1 = time.perf_counter()
                fs = [files[i] for i in idx]
                latencies.append(c1 - c0)
                frames += ops.frames(fs)
                nbytes += ops.call_bytes(op, fs, outs, config)
                if op == "decode":
                    miss = check.missing(fs, outs)
                    rec.bad_status_blocks += bad
                    rec.missing_frames += miss
                    failed += int(bad > 0 or miss > 0)
                rec.keep(keep_rng, traffic["kept_calls"], idx, outs)
                del outs
                if c1 - w0 >= seconds:
                    break
        window_s = c1 - w0
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        lat = sorted(latencies)
        print(f"window: {len(lat)} calls in {window_s:.3f} s, call s min "
              f"{lat[0]:.3f} median {lat[len(lat) // 2]:.3f} max "
              f"{lat[-1]:.3f}; process CPU user "
              f"{ru1.ru_utime - ru0.ru_utime:.3f} s, system "
              f"{ru1.ru_stime - ru0.ru_stime:.3f} s", file=log)
        device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                       "kind": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                       "count": cell.chips}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            device_info["memory_peak_bytes"] = int(
                torch.cuda.max_memory_allocated(dev))
        else:
            device_info["memory_peak_bytes"] = 0
        reduced, kernel_s = None, None
        if prof is not None:
            prof.__exit__(None, None, None)
            if trace:
                reduced = tracing.reduce(prof)
                device_info["busy_s"] = reduced["busy_s"]
                device_info["window_s"] = reduced["window_s"]
                kernel_s = reduced["kernel_s"]
            else:
                kernel_s = tracing.kernel_seconds(prof)
            del prof
        found = banned_modules()
        if found:
            print("refused: loaded after the window: " + ", ".join(found),
                  file=log)
            return 5, None
        if guards:
            idle = [c for c in counters if _counter(c) <= before[c]]
            if idle:
                print("refused: these kernels never launched in the window: "
                      + ", ".join(idle), file=log)
                return 7, None
            device_info["power_limit_w"] = power_limit_w()
            device_info["devices_visible"] = torch.cuda.device_count()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        chk_rng = rng_for(seed, inputs.STREAM_CHECK, 2)
        if op == "decode":
            nums = check.check_decode(files, rec, pool, chk_rng, control)
        else:
            nums = check.check_encode(files, rec, pool, chk_rng, control,
                                      config)
            failed = int(nums["stream_errors"] > 0
                         or nums["crc_mismatch_blocks"] > 0)
        correct, shown = check.verdict(nums)
    finally:
        pool.close()
        pool.join()

    run = SimpleNamespace(
        op=op, setup_s=setup_s, window_s=window_s, latencies=latencies,
        calls=len(latencies), frames=frames, bytes=nbytes, stages=stages,
        spans=dict(spans.seconds), trace=reduced, kernel_s=kernel_s,
        config=config)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(latencies),
              "failed": failed, "metrics": metrics, "device": device_info}
    if reduced is not None:
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    result["checks"] = shown
    for name, v in shown.items():
        print(f"check {name} = {v['value']} (limit {v['limit']})", file=log)
    return 0, result


def main(argv=None) -> int:
    t_start = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs()
    from wvbench import manifest
    try:
        cell = manifest.resolve(args.workload)
    except (KeyError, OSError) as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"refused: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    try:
        import wvpk_torch  # noqa: F401
    except ImportError as e:
        print(f"refused: the program is not in this checkout: {e}",
              file=sys.stderr)
        return 4
    rc, result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          control=bool(args.control), t_start=t_start)
    if result is not None:
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
