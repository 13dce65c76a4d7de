"""One run of one cell: set-up, the measured window, the per-layer reading of a
traced window, the check against the plain reference, the result line.

Everything that belongs to one configuration, traffic mix or per-layer metric
is a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``aec_bench/configs/<config>.json``: the configuration as it is run;
- ``aec_bench/traffic/<mix>.json``: a traffic mix's parameters, read by the
  driver the file names (``aec_bench/drivers/<driver>.py``, one per kind of
  loop: offline bulk, training steps, open-loop serving, closed-loop
  inference);
- ``aec_bench/reference/<config>.py``: the plain reference;
- ``aec_bench/metrics/<metric>.py``: a per-layer metric's reader, named by
  the metric's name up to its first dot (``k1_roofline.bulk`` ->
  ``k1_roofline.py``); it returns a number or None (nothing to read);
- ``aec_bench/checks/<cell>.json``: the limits of the numbers that decide
  ``correct`` in that cell.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "aec_tpu")


@dataclass
class Context:
    """What a driver gets: the cell and its files, the seed, the device."""

    root: Path
    cell: dict
    cfg: dict
    mix: dict
    seed: int
    device: object
    extra: dict = field(default_factory=dict)

    def path(self, rel: str) -> Path:
        return self.root / rel


def load_module(root: Path, kind: str, name: str):
    """``aec_bench/<kind>/<name>.py`` under ``root``, imported from its file."""
    path = root / "aec_bench" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(f"aec_bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"aec_bench: no {what} named {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def context(root: Path, workload: str, seed: int, device) -> tuple[Context, dict]:
    manifest = read_json(root / "BENCHMARK.json")
    cell = find(manifest["workloads"], workload, "workload")
    entry = find(manifest["configs"], cell["config"], "configuration")
    cfg = read_json(root / entry["file"])
    mix = read_json(root / "aec_bench" / "traffic" / f"{cell['traffic']}.json")
    return Context(root, cell, cfg, mix, seed, device), manifest


def set_environment(root: Path) -> None:
    """Before torch loads: every compiler cache at a fixed path inside the
    checkout (the port builds its kernels into ``aec_tpu_torch/kernels/_build``
    by itself), and one CPU thread for torch's host operators, so that a
    run's host side is one process with few threads."""
    cache = root / "aec_bench" / "_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"


def settle() -> None:
    """After set-up: the objects set-up made collected once and moved out of
    the collector's sight (``gc.freeze``), so no collection in the window
    walks the imported modules and set-up's tensors; the process kept on two
    cores of those it may use, so it does not migrate."""
    gc.collect()
    gc.freeze()
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) > 2:
        os.sched_setaffinity(0, cores[-2:])


def set_precision(cfg: dict, tf32: bool | None = None) -> None:
    """float32 with TF32 off for products and cuDNN, as the configurations
    state (``tf32`` overrides, for the lower-precision control)."""
    import torch

    on = cfg.get("tf32", False) if tf32 is None else tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole (``aec_tpu_torch`` is not ``aec_tpu``)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every number the
    cell's limits name is there, finite and within its limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def per_layer(root: Path, manifest: dict, cell: str, reading: dict) -> dict:
    out = {}
    for m in manifest["per_layer"]:
        if not applies(m, cell):
            continue
        value = load_module(root, "metrics", m["name"].split(".")[0]).read(reading)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(workload: str, seed: int, seconds: float, traced: bool, t0: float, *,
        root: Path | None = None, device=None) -> int:
    """One run; prints the result line and returns the exit code. ``device``
    None is the card, checked to be there; tests pass the CPU."""
    root = Path.cwd() if root is None else Path(root)
    set_environment(root)
    ctx, manifest = context(root, workload, seed, device)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < ctx.cell["chips"]:
            print(f"aec_bench: the cell needs {ctx.cell['chips']} CUDA card(s); "
                  f"available: {torch.cuda.is_available()}, "
                  f"count: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        ctx.device = torch.device("cuda", 0)
    set_precision(ctx.cfg)
    from aec_bench.trace import Window, reduce

    driver = load_module(root, "drivers", ctx.mix["driver"]).Cell(ctx)
    on_card = ctx.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        settle()
    setup_s = time.perf_counter() - t0
    with Window(traced) as win:
        res = driver.window(seconds, win)
    trace = reduce(win.prof, win.end - win.start) if traced else None
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    driver.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    limits = read_json(root / "aec_bench" / "checks" / f"{workload}.json")
    numbers = driver.check()
    correct, checks = verdict(numbers, limits)
    correct = correct and res["attempted"] > 0 and res["failed"] == 0
    bad = forbidden_modules()
    if bad:
        print(f"aec_bench: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3

    if traced:
        metrics = per_layer(root, manifest, workload,
                            {"trace": trace, "cfg": ctx.cfg, "mix": ctx.mix, "work": res["work"],
                             "host": res.get("host", {})})
    else:
        e2e = dict(res["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in manifest["end_to_end"] if applies(m, workload)}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": ctx.cell["chips"] if on_card else 0, "memory_peak_bytes": peak}
    line = {"correct": bool(correct), "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": dev}
    if traced:
        dev.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
        line["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
