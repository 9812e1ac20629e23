"""One run of one cell: set-up, the measured window, the check of what the
window produced, and the result line.

Everything that belongs to a configuration, a traffic mix or a per-layer
metric is found by its name in ``BENCHMARK.json``: ``configs/<name>.json``,
``traffic/<name>.json`` and ``metrics/<name>.py`` (a ``read(trace)`` that
returns a number, or None where it finds nothing to read, and the spans and
calls it reads, as ``SPANS`` and ``CALLS``: see ``spans.py``).

The window is a closed loop of whole batches through the reference API's
batch path (``create_proof_batch``, each op's ``batch_add_*``,
``process_batch``). Batches begin until ``seconds`` have passed; the batch
running at the deadline is finished and counts. ``proofs_per_s`` is every
proof of those batches over the time from the window's start to the end of
the last one.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import random
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, List, Optional

from . import traffic as traffic_mod
from .reference.envelope import SCHEMES

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
ADD = {k: f"batch_add_{k}_proof" for k in
       ("range", "equality", "threshold", "membership", "improvement", "consistency")}
FORBIDDEN = ("jax", "jaxlib", "flax", "libzkp_tpu")


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic and
    metrics, found by name."""

    def __init__(self, name: str, bench_path: Path = REPO / "BENCHMARK.json"):
        bench = json.loads(Path(bench_path).read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in {bench_path}")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = json.loads((REPO / configs[self.workload["config"]]["file"]).read_text())
        self.traffic_name = self.workload["traffic"]
        self.traffic = traffic_mod.load(ROOT / "traffic" / f"{self.traffic_name}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]

    def metric(self, name: str):
        path = ROOT / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"zkbench_metric_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def reader(self, name: str) -> Callable:
        return self.metric(name).read

    def declared(self) -> tuple:
        """The spans and calls that the cell's per-layer metrics read, each
        as its metric file declares it."""
        spans, calls = [], []
        for m in self.per_layer:
            module = self.metric(m["name"])
            spans += getattr(module, "SPANS", [])
            calls += getattr(module, "CALLS", [])
        return spans, calls


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's clock ticks."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def closed_loop(prove: Callable, batches: list, seconds: float, *, stop_after: Optional[int] = None,
                clock: Callable = time.perf_counter) -> tuple:
    """Batches back to back, each begun only while fewer than ``seconds``
    have passed since the window's start (or, with ``stop_after``, that many
    batches), the last one finished. Returns ``[(ops, proofs or None,
    seconds)]`` and the window's length, from its start to the end of the
    last batch. A batch that raises ends the window, its proofs None."""
    done: List[tuple] = []
    t_window = clock()
    while True:
        if stop_after is not None and len(done) == stop_after:
            break
        if stop_after is None and clock() - t_window >= seconds:
            break
        if len(done) == len(batches):
            raise RuntimeError(f"the window outran the mix's {len(batches)} batches")
        ops = batches[len(done)]
        t0 = clock()
        try:
            proofs = prove(ops)
        except Exception as e:  # a failed batch: its ops count as missing
            log(f"batch {len(done)} failed: {type(e).__name__}: {e}")
            done.append((ops, None, clock() - t0))
            break
        done.append((ops, proofs, clock() - t0))
    return done, clock() - t_window


def proofs_per_s(done: list, window_s: float) -> float:
    """Every op of every batch the window began, over the window."""
    return sum(len(ops) for ops, _, _ in done) / window_s


def draw_sample(lanes: List[Dict[str, list]], want: Dict[str, int], rng: random.Random) -> list:
    """The proofs that the reference checks. ``lanes[k][kind]`` holds batch
    ``k``'s ops of ``kind`` in op order, each an item or None (missing).
    The ``want[kind]`` draws of a kind stride evenly over its positions in a
    batch from an offset drawn by ``rng``, each in the next batch in turn,
    so that every position of a batch, and so every device lane, is as
    likely to be checked as any other."""
    items = []
    for kind, n in want.items():
        per_batch = [b.get(kind, []) for b in lanes]
        m = max((len(x) for x in per_batch), default=0)
        if not m or not n:
            continue
        n = min(n, sum(len(x) for x in per_batch))
        offset, first = rng.randrange(m), rng.randrange(len(per_batch))
        for j in range(n):
            batch = per_batch[(first + j) % len(per_batch)]
            pos = (offset + j * m // n) % m
            if pos < len(batch) and batch[pos] is not None:
                items.append(batch[pos])
    return items


def run(cell: Cell, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
        hook: Optional[Callable] = None) -> dict:
    """The result of one run. ``hook(zkpt)``, where given, returns a context
    manager under which the program runs: a control or a planted fault."""
    import torch

    config, spec = cell.config, cell.traffic
    torch.set_num_threads(config["host_threads"])
    log(f"host threads {torch.get_num_threads()}, affinity {len(os.sched_getaffinity(0))} cores")
    import libzkp_tpu_torch as zkpt

    from . import keys
    from .reference.verify import verdicts

    vks, reference_s = {}, 0.0
    if "snark_key_seed" in config:
        t0 = time.perf_counter()
        key_dir = keys.ensure(config)  # the reference's setup, on a checkout's first run
        vks = keys.verifying_keys(key_dir)
        reference_s = time.perf_counter() - t0  # the benchmark's own, not the program's set-up
        from libzkp_tpu_torch.models import snark_backend

        if not snark_backend.is_snark_initialized():  # a later run in one process keeps its keys
            zkpt.set_snark_key_dir(str(key_dir))
    adders = {k: getattr(zkpt, fn) for k, fn in ADD.items()}
    rec = None
    if trace:
        from .spans import Recorder
        rec = Recorder(*cell.declared())

    def prove(ops):
        span = rec.span if rec else (lambda name: contextlib.nullcontext())
        with span("api.registry"):
            bid = zkpt.create_proof_batch()
            for kind, args in ops:
                adders[kind](bid, *args)
        with span("batch"):
            return zkpt.process_batch(bid, device=device)

    with contextlib.ExitStack() as stack:
        if hook is not None:
            stack.enter_context(hook(zkpt))
        for i in range(spec["warmup_batches"]):
            t0 = time.perf_counter()
            prove(traffic_mod.batch(spec, seed, -1 - i))
            log(f"warm-up batch {i}: {time.perf_counter() - t0:.3f} s")
        batches = [traffic_mod.batch(spec, seed, i) for i in range(spec["max_batches"])]
        if device != "cpu":
            torch.cuda.synchronize()
        setup_s = process_age_s() - reference_s
        prof = None
        if rec:
            from torch.profiler import ProfilerActivity, profile
            activity = ProfilerActivity.CPU if device == "cpu" else ProfilerActivity.CUDA
            prof = stack.enter_context(profile(activities=[activity]))
            stack.enter_context(rec.installed())
        w0_ns = time.time_ns()
        done, window_s = closed_loop(prove, batches, seconds,
                                     stop_after=spec["trace_batches"] if rec else None)
        w1_ns = time.time_ns()
        if rec:
            stack.pop_all().close()  # wrappers out, profiler stopped
    for k, (ops, _, s) in enumerate(done):
        log(f"batch {k}: {len(ops)} ops, {s:.3f} s")
    memory_peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    n_ops = sum(len(ops) for ops, _, _ in done)

    # the check, once the window has closed
    t_check = time.perf_counter()
    missing, lanes = 0, []
    for ops, proofs, _ in done:
        proofs = proofs or []
        missing += max(0, len(proofs) - len(ops))  # answers to no op
        by_kind: Dict[str, list] = {}
        for i, (kind, args) in enumerate(ops):
            proof = proofs[i] if i < len(proofs) else None
            if isinstance(proof, (bytes, bytearray)) and len(proof) > 1 and proof[1] == SCHEMES[kind]:
                by_kind.setdefault(kind, []).append((kind, args, bytes(proof)))
            else:
                by_kind.setdefault(kind, []).append(None)
                missing += 1
        lanes.append(by_kind)
    items = draw_sample(lanes, spec["sample_per_kind"], random.Random(f"check:{seed}"))
    ok = verdicts(items, bits=config["range_bits"], vks=vks)
    rejected = sum(1 for v in ok if not v)
    log(f"check: {len(items)} proofs by the reference in {time.perf_counter() - t_check:.3f} s")
    compared = {"missing": {"value": missing, "limit": 0},
                "rejected": {"value": rejected, "limit": 0, "of": len(items)}}
    correct = bool(done) and bool(items) and missing <= 0 and rejected <= 0

    dev_info = {"platform": "gpu" if device != "cpu" else "cpu",
                "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
                "count": cell.workload["chips"], "memory_peak_bytes": memory_peak}
    metrics = {}
    breakdown = None
    if rec:
        import torch.autograd as ag
        from .trace import Trace

        peaks = json.loads((ROOT / "peaks.json").read_text()).get(dev_info["kind"])
        events = [(e.name(), e.start_ns(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
                  if e.device_type() == ag.DeviceType.CUDA]
        kinds = Counter(kind for ops, _, _ in done for kind, _ in ops)
        tr = Trace(device_events=events, spans=rec.spans, calls=rec.calls,
                   window=(w0_ns, w1_ns), batches=len(done), proofs=kinds, peaks=peaks)
        inside = sum(1 for _, s, _ in events if w0_ns <= s <= w1_ns)
        log(f"trace: {len(events)} device events, {inside} inside the window's host clock")
        for m in cell.per_layer:
            value = cell.reader(m["name"])(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info["busy_s"] = tr.busy_s()
        dev_info["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_by_span()}
    else:
        for m in cell.end_to_end:
            if m["name"] == "proofs_per_s":
                metrics["proofs_per_s"] = {"value": proofs_per_s(done, window_s), "unit": m["unit"]}
            elif m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
    result = {"correct": correct, "attempted": n_ops, "failed": missing + rejected,
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["card"] = card_line() if device != "cpu" else "cpu"
    result["batches"] = len(done)
    result["window_s"] = window_s
    result["compared"] = compared
    return result

