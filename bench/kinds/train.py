"""Training cells: the program's ``make_train_step`` over a pool of
batches drawn from the seed, one new batch a step.

Set-up builds the one training object (model, params from the seed in
the configuration's ``param_dtype``, AdamW state) and drives it through
its first ``check_steps`` steps, through the window's own call and feed;
the window then goes on with the same object. The window dispatches
steps back to back until ``seconds`` have passed and closes on a
``torch.cuda.synchronize()``: every step dispatched has completed in it.

After the window the program's state is freed and the plain reference
follows the first steps from the same params and batches; the numbers
compared are :func:`bench.correct.train_readings`.
"""

from __future__ import annotations

import math

import torch

import repro_torch.launch as launch
import repro_torch.models as models
import repro_torch.optim as optim
from bench import correct, harness, program, traffic
from bench.record import Outcome, Record
from bench.trace import Tracer, label


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, control: bool = False) -> Outcome:
    """One run; ``control`` also reads the e4m3 reference against the
    float32 one (readings ``<name>.control``), which the benchmark's own
    runs never do."""
    m, t = cell.config["model"], cell.traffic
    ref = harness.load_reference(cell.config["reference"])
    cfg = program.model_config(m)
    model = models.build_model(cfg, device=device)
    opt_kw = t["optimizer"]
    opt = optim.AdamWConfig(**opt_kw)
    params = ref.make_params(m, seed, device, cfg.param_dtype)
    state = optim.adamw_init(params, opt)
    step = launch.make_train_step(model, opt)
    program.note(t_start, "model, params and optimizer state")
    pool = torch.from_numpy(traffic.train_pool(seed, t, m["vocab"])).to(device)
    program.note(t_start, f"{pool.shape[0]} batches drawn")
    n_pool, k = pool.shape[0], t["check_steps"]

    # the checked steps: the first of the object the window drives
    first = ref.leaves(params)
    losses = []
    for i in range(k):
        params, state, met = step(params, state, {"tokens": pool[i]})
        losses.append(met["loss"])
        if i == 0:
            grads = correct.leaf_norms(ref.leaves(state["mu"]),
                                       1.0 / (1.0 - opt.b1))
    now = ref.leaves(params)
    prog = {"losses": [float(x) for x in losses], "grad_norms": grads,
            "update_norms": correct.leaf_norms(
                {p: now[p].float() - first[p].float() for p in now})}
    del first, now
    program.sync(device)
    program.note(t_start, f"{k} checked steps")

    program.settle()
    tracer = Tracer(trace)
    if trace:
        step = label(step, "step")
    with program.spans(trace):
        before = program.launches()
        tracer.start()
        program.sync(device)
        window_losses = []
        with tracer.window():
            t_open = program.clock()
            n = 0
            while program.clock() - t_open < seconds:
                params, state, met = step(
                    params, state, {"tokens": pool[(k + n) % n_pool]})
                window_losses.append(met["loss"])
                n += 1
            program.sync(device)
            t_close = program.clock()
        tracer.stop()
        launched = program.launches_since(before)
    failed = sum(not math.isfinite(float(x)) for x in window_losses)
    peak = program.memory_peak(device)

    record = Record(model=m, traffic=t, setup_s=t_open - t_start,
                    window_s=t_close - t_open, trace=tracer.stats,
                    launches=launched, steps=n)
    del params, state, met, window_losses, model, step
    program.release(device)

    program.note(t_start, f"window closed: {n} steps")
    P0 = ref.make_params(m, seed, device, cfg.param_dtype)
    batches = [pool[i] for i in range(k)]
    refr = correct.reference_train(ref, m, P0, batches, opt_kw,
                                   t["reference_rows"])
    readings = correct.train_readings(prog, refr)
    program.note(t_start, f"reference followed; the change compared on "
                 f"{len(refr['moved'])} of {len(refr['grad_norms'])} leaves")
    if control:
        low = correct.reference_train(ref, m, P0, batches, opt_kw,
                                      t["reference_rows"], fp8=True)
        readings.update({f"{k}.control": v for k, v in
                         correct.train_readings(low, refr).items()})
    return Outcome(record=record, readings=readings, attempted=n,
                   failed=failed, memory_peak_bytes=peak)
