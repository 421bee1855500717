"""The serving driver: requests arrive at the traffic's fixed rate (an open
loop: due every ``1 / rate`` seconds whether or not earlier ones are
done), and ``clients`` threads, the handler threads of a serving host,
each take the next due request and call ``InferenceSession.predict``;
each request is a batch of the pool with CVAE noise seeded for it. When
the window closes the clients take no more requests. Above what the
session sustains, the end-to-end metric is the points of the requests
completed in the window over its length. Then a sample of the answers
the window served, drawn from the seed, is held against the reference.

With ``--trace 1`` the window is measured in three parts: the open loop
untraced (the time a request takes at this load, for ``mfu``), one client
with a span around the session's ``run`` (the host's share of
``predict``), and a short ``torch.profiler`` window over the open loop."""

from __future__ import annotations

import contextlib
import gc
import heapq
import shutil
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from bench_h100 import compare, scenes, stats, trace, workcount
from bench_h100.reference import model as ref

CHECK_REQUESTS = 12  # answers held against the reference, drawn from the seed
PROFILED_REQUESTS = 40
SPANS = ("replay", "predict")


def request_seed(seed: int, i: int) -> int:
    """Request ``i``'s noise seed (``predict``'s ``seed``)."""
    return int(np.random.SeedSequence(entropy=int(seed), spawn_key=(i, 7)).generate_state(1)[0])


def request_noise(seed: int, shape) -> torch.Tensor:
    """The CVAE noise ``predict(..., seed=seed)`` feeds a one-chunk request:
    a float32 normal draw on the CPU from a generator seeded by
    ``SeedSequence(entropy=seed, spawn_key=(0, 1))``."""
    state = np.random.SeedSequence(entropy=int(seed), spawn_key=(0, 1)).generate_state(1, np.uint64)
    gen = torch.Generator(device="cpu").manual_seed(int(state[0]))
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32)


def inputs(cfg: dict, traffic: dict, seed: int, device):
    """What the seed makes: ``(state, pool, order)``: the weights on
    ``device``, the pool of request batches and the order requests take
    them in (request ``i`` takes ``pool[order[i % len(pool)]]``)."""
    gen = torch.Generator(device=device).manual_seed(scenes.seed_int(seed, 3))
    state = ref.seeded_state(ref.param_spec(cfg), gen, device)
    pool = scenes.pool(traffic, seed)
    return state, pool, scenes.seed_rng(seed, 2).permutation(len(pool))


def reference_answer(cfg: dict, traffic: dict, state: dict, pool, order, seed: int, i: int,
                     device) -> dict:
    """The reference's answer to request ``i``."""
    shape = (traffic["batch"], cfg["num_seeds"], cfg["gspn"]["latent_dim"])
    b = scenes.to_device(pool[order[i % len(order)]], device)
    z = request_noise(request_seed(seed, i), shape).to(device)
    with torch.no_grad():
        return ref.infer(cfg, state, b["xyz"], b["valid"], z)


def reference_check(cfg, traffic, state, pool, order, seed, answers: dict,
                    device) -> compare.ServeCheck:
    """The answers ``{request index: predict's dict}`` held against the
    reference's."""
    check = compare.ServeCheck()
    for i in sorted(answers):
        check.add(answers[i], reference_answer(cfg, traffic, state, pool, order, seed, i, device))
    return check


def _closed_loop(session, pool, order, seed, start_i, seconds):
    """One client's requests back to back from index ``start_i`` until
    ``seconds`` have passed: ``(latencies, failed, next index)``."""
    lat, failed, i = [], 0, start_i
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        j = order[i % len(order)]
        t = time.perf_counter()
        try:
            session.predict(pool[j]["xyz"], pool[j]["valid"], seed=request_seed(seed, i))
        except Exception as e:  # noqa: BLE001 — a request that fails counts as failed
            failed += 1
            print(f"request {i} failed: {e!r}", flush=True)
        lat.append(time.perf_counter() - t)
        i += 1
    return lat, failed, i


class Sample:
    """The answers held against the reference: of every request that
    returned, the ``size`` whose keys, drawn from the seed for each request
    index, are the smallest (a uniform sample of the requests the window
    served, whichever they were)."""

    def __init__(self, seed: int, size: int = CHECK_REQUESTS):
        self.seed, self.size = int(seed), size
        self.heap: list = []  # (-key, index, answer), the largest key first

    def key(self, i: int) -> int:
        return int(np.random.SeedSequence(entropy=self.seed, spawn_key=(i, 11))
                   .generate_state(1, np.uint64)[0])

    def offer(self, i: int, answer: dict) -> None:
        item = (-self.key(i), i, answer)
        if len(self.heap) < self.size:
            heapq.heappush(self.heap, item)
        elif item[0] > self.heap[0][0]:
            heapq.heapreplace(self.heap, item)

    def answers(self) -> dict:
        return {i: a for _, i, a in self.heap}

    def pick(self, n: int) -> list[int]:
        """The indices the sample would hold had requests ``0 .. n - 1``
        all returned."""
        return sorted(sorted(range(n), key=self.key)[:self.size])


def open_loop(session, pool, order, seed, start_i: int, seconds: float, rate: float,
              clients: int, sample: Sample | None = None, spans: trace.Spans | None = None,
              requests: int | None = None) -> dict:
    """Requests ``start_i, start_i + 1, ...`` due every ``1 / rate`` seconds
    from now, whether or not earlier ones are done, for ``seconds`` (or the
    first ``requests`` of them), served by ``clients`` threads that each
    take the next due request. When the window closes the clients take no
    more: a request due in it that no client started is not completed, and
    not failed; one that raises fails. A request's latency runs from when
    it was due. Returns ``start`` (the window's start on
    ``time.perf_counter``), ``done`` ({index: completion time}),
    ``latency`` ({index: seconds}), ``started``, ``failed`` and ``next``,
    the first index no client took. ``sample``
    is offered every answer; ``spans`` records each ``predict``."""
    lock = threading.Lock()
    nxt, started, failed = [0], [0], [0]
    done, latency = {}, {}
    t0 = time.perf_counter()
    close = t0 + seconds

    def worker():
        while True:
            with lock:
                i = nxt[0]
                if (requests is not None and i >= requests) or time.perf_counter() >= close:
                    return
                due = t0 + i / rate
                if due >= close:
                    return
                nxt[0] += 1
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            if time.perf_counter() >= close:
                return
            with lock:
                started[0] += 1
            j = order[(start_i + i) % len(order)]
            try:
                with spans("predict") if spans else contextlib.nullcontext():
                    out = session.predict(pool[j]["xyz"], pool[j]["valid"],
                                          seed=request_seed(seed, start_i + i))
            except Exception as e:  # noqa: BLE001 — a request that fails counts as failed
                with lock:
                    failed[0] += 1
                print(f"request {start_i + i} failed: {e!r}", flush=True)
                continue
            t = time.perf_counter()
            with lock:
                done[i], latency[i] = t, t - due
                if sample is not None:
                    sample.offer(start_i + i, out)

    threads = [threading.Thread(target=worker, name=f"client-{c}") for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {"start": t0, "done": done, "latency": latency, "started": started[0],
            "failed": failed[0], "next": start_i + nxt[0]}


def completed(res: dict, pool_points, order, start_i: int, seconds: float):
    """``(requests, valid points, latencies)`` of the requests completed
    within ``seconds`` of the window's start."""
    end = res["start"] + seconds
    idx = [i for i, t in res["done"].items() if t <= end]
    return (len(idx), sum(pool_points[order[(start_i + i) % len(order)]] for i in idx),
            [res["latency"][i] for i in idx])


def run(cfg: dict, traffic: dict, seed: int, seconds: float, traced: bool, device) -> dict:
    from bench_h100 import program

    if sorted(k for k, _, _ in ref.param_spec(cfg)) != sorted(program.state_keys(cfg)):
        raise RuntimeError("the reference's parameters are not the program's")
    rate, clients = traffic["rate"], traffic["clients"]
    t0 = time.perf_counter()
    state, pool, order = inputs(cfg, traffic, seed, device)
    valid_points = [int(b["valid"].sum()) for b in pool]
    sample = Sample(seed)
    workdir = tempfile.mkdtemp(prefix="bench_h100_")
    try:
        t1 = time.perf_counter()
        session = program.session(cfg, state, traffic["batch"], traffic["points"], device, workdir)
        t2 = time.perf_counter()
        # every shape of the window (the one request shape), one client and
        # all of them at once
        warm = open_loop(session, pool, order, scenes.seed_int(seed, 4), 0, float("inf"),
                         float("inf"), clients, requests=2 * clients)
        if warm["failed"]:
            raise RuntimeError("a warm-up request failed")
        setup_end = time.perf_counter()
        out = {"setup_end": setup_end, "setup_parts": {
            "weights and pool": t1 - t0, "export and capture": t2 - t1,
            "warm-up": setup_end - t2}}
        window = seconds if not traced else seconds * 0.5
        res = open_loop(session, pool, order, seed, 0, window, rate, clients, sample)
        done, pts, _ = completed(res, valid_points, order, 0, window)
        n, failed = res["started"], res["failed"]
        print(f"window {window} s: {res['started']} requests started, {done} completed in it, "
              f"{failed} failed", file=sys.stderr)
        if not traced:
            out["e2e"] = {"serve_points_per_s": stats.rate(pts, window)}
        else:
            i = res["next"]
            with _run_span(session, sync=True) as runs:
                host_lat, f, i = _closed_loop(session, pool, order, seed, i, seconds * 0.3)
            host_ms = 1e3 * sum(a - b for a, b in zip(host_lat, runs)) / max(len(host_lat), 1)
            n += len(host_lat)
            failed += f
            profiled, spans = {}, trace.Spans()

            def burst():
                profiled["res"] = open_loop(session, pool, order, seed, i, float("inf"), rate,
                                            clients, spans=spans, requests=PROFILED_REQUESTS)

            with _replay_span(session, spans):
                win = trace.profile(burst, 1, spans, SPANS, units=PROFILED_REQUESTS)
            n += profiled["res"]["started"]
            failed += profiled["res"]["failed"]
            out["layer"] = {"kind": "serve", "call_s": window / max(done, 1), "window": win,
                            "host_ms": host_ms}
        out.update(attempted=n, failed=failed,
                   memory_peak_bytes=torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
        del session
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with workcount.counting() as tally:
        check = reference_check(cfg, traffic, state, pool, order, seed, sample.answers(), device)
    if check.requests == 0:
        raise RuntimeError("no answer of the window was kept for the check")
    out["numbers"] = check.numbers()
    out["checked"] = check.summary()
    if traced:
        out["layer"].update(matmul_flops=tally.matmul_flops / check.requests,
                            point_least_s=tally.point_op_least_s() / check.requests)
    return out


@contextlib.contextmanager
def _run_span(session, sync: bool):
    """A span around the session's ``run`` (an instance attribute over the
    method, removed after the block); with ``sync`` it ends in a
    synchronize, so it holds the device work; its seconds are yielded a
    call."""
    orig, runs = session.run, []

    def run(*a, **k):
        t = time.perf_counter()
        res = orig(*a, **k)
        if sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        runs.append(time.perf_counter() - t)
        return res

    session.run = run
    try:
        yield runs
    finally:
        del session.run


@contextlib.contextmanager
def _replay_span(session, spans: trace.Spans):
    """A span named "replay" around the session's CUDA-graph call (inside
    ``run``'s lock, so a client waiting for the lock is not in it), where
    the session has one; without it the gaps are labelled by ``predict``
    alone."""
    graphed = getattr(session, "_graphed", None)
    if graphed is None:
        yield
        return

    def replay(*a):
        with spans("replay"):
            return graphed(*a)

    session._graphed = replay
    try:
        yield
    finally:
        session._graphed = graphed

