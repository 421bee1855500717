"""The training driver: one training step object (model, Adam, the step
the trainer runs) built from the seed, driven through its first three
steps in set-up, then stepped back to back for the window; each step
takes the next batch of the pool (held on the card) and a generator
seeded for that step. The first three steps are held against the
reference's, from the same weights, batches and draws; and so are three
steps from inside the window, the last whose start the window snapshots
(every ``SNAPSHOT_EVERY`` steps it copies the program's parameters,
BatchNorm statistics and Adam moments), against the reference's three
steps from that copy on the same batches and draws.

With ``--trace 1`` the window is measured untraced (the time a step
takes, for ``mfu``), then under a short ``torch.profiler`` window with
spans around the step and the optimizer."""

from __future__ import annotations

import gc
import time

import torch

from bench_h100 import compare, scenes, stats, trace, workcount
from bench_h100.reference import model as ref
from bench_h100.reference import train as ref_train

CHECKED_STEPS = 3
SNAPSHOT_EVERY = 16
PROFILED_STEPS = 6
SPANS = ("optimizer", "step")


def step_generator(seed: int, i: int, device) -> torch.Generator:
    """Step ``i``'s generator on ``device``, seeded from ``(seed, i)``."""
    return torch.Generator(device=device).manual_seed(scenes.seed_int(seed, 5, i))


def inputs(cfg: dict, traffic: dict, seed: int, device):
    """What the seed makes: ``(state, frozen, pool, order)``: the weights
    on ``device`` (and stage 2's frozen GSPN's), the pool of batches on
    ``device`` and the order steps take them in (step ``i`` takes
    ``pool[order[i % len(pool)]]``)."""
    state = ref.seeded_state(ref.param_spec(cfg), torch.Generator(device=device).manual_seed(
        scenes.seed_int(seed, 3)), device)
    frozen = None
    if cfg["kind"] == "rpointnet_train":
        frozen = ref.seeded_state(ref.frozen_spec(cfg), torch.Generator(device=device).manual_seed(
            scenes.seed_int(seed, 6)), device)
    pool = [scenes.to_device(b, device) for b in scenes.pool(traffic, seed)]
    return state, frozen, pool, scenes.seed_rng(seed, 2).permutation(len(pool))


def trainable(state: dict) -> set:
    """The parameters: every leaf but the BatchNorm running statistics."""
    return {k for k in state if not k.endswith((".mean", ".var"))}


def reference_steps(cfg, state, frozen, pool, order, seed, device, rows=None) -> list:
    """The reference's first steps from ``state`` on the window's batches
    and draws (``rows``: a slice of each batch, for a planted fault)."""
    batches = [pool[order[i]] for i in range(CHECKED_STEPS)]
    if rows is not None:
        batches = [{k: v[rows] for k, v in b.items()} for b in batches]
    return ref_train.train_steps(cfg, state, batches,
                                 [step_generator(seed, i, device) for i in range(CHECKED_STEPS)],
                                 frozen, trainable(state))


def numbers(state: dict, losses, first_grad: dict, after: dict, want: list) -> dict:
    """The training cell's numbers (``compare.train_numbers``) of the
    program's losses, first gradient and state after the checked steps
    against the reference's steps ``want``."""
    params = trainable(state)
    buffers = sorted(set(state) - params)
    init = compare.to_cpu(state)
    last = compare.to_cpu(want[-1]["state"])
    ref_grads = compare.to_cpu(want[0]["grads"])
    return compare.train_numbers(
        losses, [float(s["loss"]) for s in want],
        {k: first_grad[k] for k in ref_grads}, ref_grads,
        {k: after[k] - init[k] for k in params}, {k: last[k] - init[k] for k in params},
        {k: after[k] - init[k] for k in buffers}, {k: last[k] - init[k] for k in buffers})


class WindowCheck:
    """Copies of the program's state around ``CHECKED_STEPS`` steps of the
    window, one set begun every ``SNAPSHOT_EVERY`` steps: before the first
    (the model's state, each parameter's Adam moments), after the first
    (its first moments, which hold the gradient Adam received) and after
    the last (the model's state); and the steps' losses. ``latest`` is the
    last set completed. The copies go into two sets of buffers allocated
    here, in set-up, taken in turn, so the window allocates nothing."""

    def __init__(self, ts, first: int):
        self.first = first
        state = ts.model.state_dict()
        opt = ts.optimizer.state
        params = [(k, p) for k, p in ts.model.named_parameters() if p in opt]
        self.keys, self.state_src = list(state), [v.detach() for v in state.values()]
        self.pkeys = [k for k, _ in params]
        self.m_src = [opt[p]["exp_avg"] for _, p in params]
        self.v_src = [opt[p]["exp_avg_sq"] for _, p in params]
        self.sets = [self._buffers(), self._buffers()]
        self.open: dict | None = None
        self.latest: dict | None = None

    def _buffers(self) -> dict:
        def like(ts):
            return [torch.empty_like(t) for t in ts]
        return {"state": like(self.state_src), "m": like(self.m_src), "v": like(self.v_src),
                "m_after": like(self.m_src), "after": like(self.state_src)}

    def before(self, i: int) -> None:
        if (i - self.first) % SNAPSHOT_EVERY:
            return
        buf = self.sets[0] if self.latest is None or self.latest["buf"] is not self.sets[0] \
            else self.sets[1]
        torch._foreach_copy_(buf["state"], self.state_src)
        torch._foreach_copy_(buf["m"], self.m_src)
        torch._foreach_copy_(buf["v"], self.v_src)
        self.open = {"step": i, "losses": [], "buf": buf}

    def after(self, i: int, loss) -> None:
        c = self.open
        if c is None:
            return
        c["losses"].append(loss.detach())
        if i == c["step"]:
            torch._foreach_copy_(c["buf"]["m_after"], self.m_src)
        if i == c["step"] + CHECKED_STEPS - 1:
            torch._foreach_copy_(c["buf"]["after"], self.state_src)
            self.latest, self.open = c, None

    def snapshot(self) -> dict:
        """The last set completed: ``step``, ``losses``, ``state``,
        ``moments`` ({leaf: (m, v)}), ``m_after`` and ``after``, by name."""
        c = self.latest
        buf = c["buf"]
        return {"step": c["step"], "losses": c["losses"],
                "state": dict(zip(self.keys, buf["state"])),
                "moments": {k: (m, v) for k, m, v in zip(self.pkeys, buf["m"], buf["v"])},
                "m_after": dict(zip(self.pkeys, buf["m_after"])),
                "after": dict(zip(self.keys, buf["after"]))}


def window_reference(cfg, snap, frozen, pool, order, seed, device, rows=None) -> list:
    """The reference's steps from the window's snapshot ``snap`` on the
    window's batches and draws (``rows``: a slice of each batch)."""
    i0 = snap["step"]
    batches = [pool[order[i % len(order)]] for i in range(i0, i0 + CHECKED_STEPS)]
    if rows is not None:
        batches = [{k: v[rows] for k, v in b.items()} for b in batches]
    return ref_train.train_steps(
        cfg, snap["state"], batches,
        [step_generator(seed, i, device) for i in range(i0, i0 + CHECKED_STEPS)],
        frozen, trainable(snap["state"]), moments=snap["moments"], done=i0)


def window_numbers(snap: dict, want: list, beta1: float = ref_train.ADAM_B1) -> dict:
    """The numbers of ``numbers`` for the window's steps, each name
    prefixed ``window_``: the program's gradient of the first step is
    worked out from its first moments before and after it."""
    grads = {k: (snap["m_after"][k] - beta1 * m) / (1.0 - beta1)
             for k, (m, _) in snap["moments"].items()}
    nums = numbers(snap["state"], [float(x) for x in snap["losses"]], compare.to_cpu(grads),
                   compare.to_cpu(snap["after"]), want)
    return {f"window_{k}": v for k, v in nums.items()}


def run(cfg: dict, traffic: dict, seed: int, seconds: float, traced: bool, device,
        keep: dict | None = None) -> dict:
    """One run; ``keep``, where given, receives the window's snapshot and
    the inputs (``calibrate.py`` holds its control against them)."""
    from bench_h100 import program

    spec = ref.param_spec(cfg)
    if sorted(k for k, _, _ in spec) != sorted(program.state_keys(cfg)):
        raise RuntimeError("the reference's parameters are not the program's")
    t0 = time.perf_counter()
    state, frozen, pool, order = inputs(cfg, traffic, seed, device)
    t1 = time.perf_counter()
    step, ts = program.train_step(cfg, state, frozen, device)
    t2 = time.perf_counter()

    losses, first_grad = [], None
    for i in range(CHECKED_STEPS):
        losses.append(step(pool[order[i]], step_generator(seed, i, device))["loss"])
        if i == 0:
            first_grad = compare.to_cpu(program.first_gradient(ts))
    after = compare.to_cpu({k: v for k, v in ts.model.state_dict().items()})
    losses = [float(x) for x in losses]
    out = {"setup_end": time.perf_counter()}
    out["setup_parts"] = {"weights and pool": t1 - t0, "model and optimizer": t2 - t1,
                          f"the first {CHECKED_STEPS} steps": out["setup_end"] - t2}
    scenes_per_step = traffic["batch"]

    check = WindowCheck(ts, CHECKED_STEPS)

    def one_step(i):
        check.before(i)
        check.after(i, step(pool[order[i % len(order)]], step_generator(seed, i, device))["loss"])

    def window(i0, secs):
        i = i0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < secs:
            one_step(i)
            i += 1
        if device.type == "cuda":
            torch.cuda.synchronize()
        return i, time.perf_counter() - t0

    n, secs = window(CHECKED_STEPS, seconds if not traced else seconds * 0.7)
    while check.latest is None:  # a window too short for one: the steps after it
        one_step(n)
        n += 1
    if not traced:
        out["e2e"] = {"train_scenes_per_s": stats.rate((n - CHECKED_STEPS) * scenes_per_step, secs)}
    else:
        call_s = secs / (n - CHECKED_STEPS)
        j, spans = [n], trace.Spans()
        opt_step = ts.optimizer.step

        def optimizer_span(*a, **k):
            with spans("optimizer"):
                return opt_step(*a, **k)

        def one():
            with spans("step"):
                step(pool[order[j[0] % len(order)]], step_generator(seed, j[0], device))
            j[0] += 1

        ts.optimizer.step = optimizer_span
        try:
            win = trace.profile(one, PROFILED_STEPS, spans, SPANS)
        finally:
            del ts.optimizer.step
        n = j[0]
        out["layer"] = {"kind": "train", "call_s": call_s, "window": win}
    out.update(attempted=n, failed=0,
               memory_peak_bytes=torch.cuda.max_memory_allocated(device)
               if device.type == "cuda" else 0)
    snap = check.snapshot()
    del step, ts, check
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    with workcount.counting(grad_factor=3) as tally:
        want = reference_steps(cfg, state, frozen, pool, order, seed, device)
    out["numbers"] = numbers(state, losses, first_grad, after, want)
    in_window = window_reference(cfg, snap, frozen, pool, order, seed, device)
    out["numbers"].update(window_numbers(snap, in_window))
    out["checked"] = (f"the first {CHECKED_STEPS} steps checked: losses {losses}, the "
                      f"reference's {[float(w['loss']) for w in want]}; steps {snap['step']}–"
                      f"{snap['step'] + CHECKED_STEPS - 1} of {n}: losses "
                      f"{[float(x) for x in snap['losses']]}, the reference's "
                      f"{[float(w['loss']) for w in in_window]}")
    if keep is not None:
        keep.update(snap=snap, frozen=frozen, pool=pool, order=order)
    if traced:
        out["layer"].update(matmul_flops=tally.matmul_flops / CHECKED_STEPS,
                            point_least_s=tally.point_op_least_s() / CHECKED_STEPS)
    return out
