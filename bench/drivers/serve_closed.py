"""A closed loop of clients against the port's ``ServingEngine``.

Set-up draws the weights, masks and packs them, builds the engine, sends
every client's first request and runs the first ``pump`` (every slot
admitted, both compiled steps captured).  The window then pumps the
engine; after each pump every finished request's client sends its next
one, until ``seconds`` have passed.  The window closes at the end of that
pump, so every request sent in it has been admitted.

Spans and counters are the harness's own, taken around each ``pump``:
its host interval and its deltas of ``engine.stats``; each token's time
comes from the request's ``on_token`` hook.  With ``trace`` a
``torch.profiler`` slice covers ``mix["trace"]``'s part of the window.

After the window the program's state is freed, and the reference
(``bench/reference/decoder_lm.py``, float32) runs over a sample of the
finished requests: the prompt and the served tokens.  The number judged
is the mean, over every served token of the sample, of the gap by which
the served token's reference logit lies below the reference's best at
that position (the widest gap is read beside it; ``PERF.md`` says why it
is not the number judged).
"""
from __future__ import annotations

import collections
import gc
import time

import numpy as np

from bench.lib import stats
from bench.lib import weights as W
from bench.lib.common import judge, log
from bench.lib.port import model_config, served_params
from bench.lib.trace import Slice
from bench.lib.traffic import closed_loop_plan, sub_seed
from bench.reference import decoder_lm as R


def _k2_counts() -> collections.Counter:
    from repro_torch.kernels import nm_spmm

    return collections.Counter(nm_spmm.nm_matmul_cuda.by_shape)


def run(ctx) -> dict:
    torch, dev, mix, seed = ctx.torch, ctx.device, ctx.mix, ctx.seed
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine

    cfg = model_config(ctx.conf)
    n = int(mix["clients"])
    model = TransformerLM(cfg, device=dev)
    params = served_params(torch, cfg, seed, dev)
    eng = ServingEngine(model, params, ServeConfig(
        batch_slots=int(mix["slots"]), max_len=int(mix["max_len"]),
        greedy=True, eos_id=-1, scheduler="continuous"))
    plan = closed_loop_plan(mix, seed, cfg.vocab_size, dev, torch)
    times: dict[int, list] = {}
    owner: dict[int, int] = {}
    reqs: dict[int, object] = {}
    nxt = [0] * n

    def on_token(req, _tok) -> None:
        times[req.uid].append(time.perf_counter())

    def submit(c: int) -> None:
        j = nxt[c]
        if j >= plan.max_new.shape[0]:
            raise RuntimeError(f"client {c} ran out of its {j} rounds: "
                               "raise the mix's rounds")
        nxt[c] += 1
        uid = j * n + c
        p = int(plan.prompt_len[j, c])
        req = Request(uid=uid, prompt=plan.ids[j, c, :p],
                      max_new=int(plan.max_new[j, c]), on_token=on_token)
        times[uid], owner[uid], reqs[uid] = [], c, req
        eng.submit(req)

    def drain(resubmit: bool) -> list:
        done, eng.finished = eng.finished, []
        if resubmit:
            for req in done:
                submit(owner[req.uid])
        return done

    for c in range(n):
        submit(c)
    eng.pump()
    drain(True)
    if ctx.trace:
        # the profiler's first start costs seconds (CUPTI set-up): pay it
        # here, around one more pump, and not in the traced slice
        warm = Slice(torch)
        warm.start()
        eng.pump()
        drain(True)
        warm.stop()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        ctx.setup_lines.append(f"engine graphs: {eng.graph_stats()}")
        ctx.setup_lines.append(
            f"peak memory at the window's opening: "
            f"{torch.cuda.max_memory_allocated(0)} bytes")

    # ------------------------------------------------------------ window
    tr = mix["trace"]
    slc = Slice(torch) if ctx.trace else None
    slice_rec: dict = {}
    pumps = []
    finished = []
    prev = dict(eng.stats)
    t_open = time.perf_counter()
    deadline = t_open + ctx.seconds
    now = t_open
    while True:
        if slc is not None and not slice_rec and \
                now >= t_open + float(tr["start_s"]):
            slice_rec = {"t0": now, "stats0": dict(eng.stats),
                         "k2_0": _k2_counts()}
            slc.start()
        eng.pump()
        t1 = time.perf_counter()
        st = dict(eng.stats)
        pumps.append((now, t1, st["prefills"] - prev["prefills"],
                      st["prefill_tokens"] - prev["prefill_tokens"],
                      st["decode_steps"] - prev["decode_steps"],
                      st["busy_slot_steps"] - prev["busy_slot_steps"]))
        prev = st
        if slc is not None and slice_rec and "t1" not in slice_rec and \
                t1 >= slice_rec["t0"] + float(tr["seconds"]):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            slice_rec.update(t1=time.perf_counter(), stats1=dict(eng.stats),
                             k2_1=_k2_counts())
            slc.stop()
            slice_rec["resume"] = time.perf_counter()
        finished += drain(t1 < deadline)
        now = time.perf_counter()
        if t1 >= deadline:
            break
    t_close = t1
    if slc is not None and "t1" not in slice_rec:
        raise RuntimeError("the traced slice did not close inside the window")
    mem_peak = int(torch.cuda.max_memory_allocated(0)) \
        if dev.type == "cuda" else 0

    # ------------------------------------------------------- end to end
    in_win = [t for ts in times.values() for t in ts if t_open <= t <= t_close]
    gaps = [b - a for ts in times.values() for a, b in zip(ts, ts[1:])
            if a >= t_open and b <= t_close]
    ttft = [reqs[u].t_first - reqs[u].t_submit for u in reqs
            if t_open <= reqs[u].t_submit <= t_close]
    e2e = {"output_tok_s": stats.rate(len(in_win), t_open, t_close),
           "itl_p95_ms": 1e3 * stats.percentile(gaps, 95),
           "ttft_p90_ms": 1e3 * stats.percentile(ttft, 90)}
    window_done = [r for r in finished if t_open <= r.t_done <= t_close]
    log(f"window {t_close - t_open:.3f} s: {len(in_win)} tokens, "
        f"{len(gaps)} gaps, {len(ttft)} requests sent, "
        f"{len(window_done)} finished, {len(pumps)} pumps")

    # the profiler slows the pumps it traces and its export stops the
    # loop: spans and rates come from the rest of the window
    spans = [(t_open, t_close)]
    if slice_rec:
        spans = [(t_open, slice_rec["t0"]), (slice_rec["resume"], t_close)]
    pumps_out = [p for p in pumps if any(a <= p[0] and p[1] <= b
                                         for a, b in spans)]
    rec = {"cfg": cfg, "slots": int(mix["slots"]), "pumps": pumps_out,
           "clean_s": sum(b - a for a, b in spans), "slice": slice_rec,
           "trace": slc.summary if slc is not None else None,
           "slice_s": (slice_rec["t1"] - slice_rec["t0"]) if slc else None,
           "tokens": _token_contexts(reqs, times, spans)}

    # --------------------------------------------------------- the check
    failed = sum(1 for r in window_done if r.error)
    sample = _sample(window_done, int(ctx.limits["sample"]), seed)
    seqs = [(np.asarray(r.prompt, np.int64), list(r.out)) for r in sample]
    del eng, params, model, reqs, finished, window_done, sample
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    readings = reference_gaps(torch, cfg, seed, dev, seqs,
                              control=ctx.control)
    log(f"reference over {len(seqs)} requests "
        f"({sum(len(o) for _, o in seqs)} served tokens): "
        f"{time.perf_counter() - t_ref:.1f} s")
    compared = ["serve_gap_mean"]
    checks = judge(readings, ctx.limits, compared)
    control = judge(readings, ctx.limits, compared, "control_") \
        if ctx.control else None
    return {"end_to_end": e2e, "records": rec, "checks": checks,
            "control_checks": control,
            "readings": readings, "attempted": len(ttft),
            "failed": failed,
            "memory_peak_bytes": mem_peak, "t_open": t_open}


def _token_contexts(reqs, times, spans) -> dict:
    """Tokens the model processed in the window's ``spans``, by context
    length, apart for those whose logits were needed (``head``: the last
    prompt position and every decode step) and the other prompt positions
    (``body``).  A prompt is prefilled at its request's admission (stamped
    by its first token); a decode step is stamped by the token it
    produced, and the last token is never fed back."""
    head: collections.Counter = collections.Counter()
    body: collections.Counter = collections.Counter()

    def inside(t):
        return any(a <= t <= b for a, b in spans)

    for uid, req in reqs.items():
        ts = times[uid]
        P = len(req.prompt)
        if ts and inside(ts[0]):
            for p in range(P - 1):
                body[p + 1] += 1
            head[P] += 1
        for k, t in enumerate(ts[1:], start=1):
            if inside(t):
                head[P + k] += 1
    return {"head": dict(head), "body": dict(body)}


def _sample(done: list, k: int, seed: int) -> list:
    """The longest finished request and k − 1 others drawn from the seed."""
    if not done:
        raise RuntimeError("no request finished in the window")
    done = sorted(done, key=lambda r: r.uid)
    longest = max(done, key=lambda r: (len(r.prompt) + len(r.out), -r.uid))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng(sub_seed(seed, 4))
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def reference_gaps(torch, cfg, seed: int, dev, seqs: list, *,
                   control: bool = False) -> dict:
    """Run the float32 reference over each (prompt, served tokens) and read
    the widest gap between a position's best reference logit and the served
    token's.  With ``control`` the same in float8 (``decoder_lm.fp8_cast``)
    beside it, and the gap of the token the float8 model puts first."""
    R.setup_fp32()
    streams = {"ref": R.identity}
    if control:
        streams["ctl"] = R.fp8_cast
    dt = cfg.torch_dtype
    f32 = torch.float32
    head = W.head_weights(torch, cfg, seed, dev, dt)
    hs = {}
    for name in streams:
        hs[name] = [head["embed"]["table"][torch.as_tensor(
            np.concatenate([p, np.asarray(o[:-1], np.int64)]), device=dev)
        ].to(f32) for p, o in seqs]
    for i in range(cfg.num_layers):
        w = _masked_f32(torch, W.block_weights(torch, cfg, i, seed, dev, dt),
                        cfg, i)
        moe_layer = bool(cfg.num_experts) and i >= cfg.num_dense_layers
        with torch.no_grad():
            for name, cast in streams.items():
                hs[name] = [R.block(cfg, w, h, moe_layer=moe_layer, cast=cast)
                            for h in hs[name]]
        del w
    hw = {"final_norm": {"scale": head["final_norm"]["scale"].to(f32)},
          "lm_head": {"w": head["lm_head"]["w"].to(f32)}}
    gaps, ctl = [], []
    with torch.no_grad():
        for s, (p, o) in enumerate(seqs):
            P = len(p)
            rows = R.logits(hw, hs["ref"][s][P - 1:])
            served = torch.as_tensor(o, device=dev)
            best = rows.max(-1).values
            gaps.append(best - rows.gather(1, served[:, None])[:, 0])
            if control:
                top = R.logits(hw, hs["ctl"][s][P - 1:], R.fp8_cast).argmax(-1)
                ctl.append(best - rows.gather(1, top[:, None])[:, 0])
    out = _gap_stats(torch.cat(gaps), "serve_")
    if control:
        out.update(_gap_stats(torch.cat(ctl), "control_serve_"))
    return out


def _gap_stats(g, prefix: str) -> dict:
    """The widest gap, its mean over every token, and the share of tokens
    that are not the reference's first (gap > 0)."""
    g = g.double()
    return {prefix + "gap_max": float(g.max()),
            prefix + "gap_mean": float(g.mean()),
            prefix + "not_top1": float((g > 0).double().mean()),
            prefix + "tokens": int(g.numel())}


def _masked_f32(torch, blk: dict, cfg, i: int) -> dict:
    """Block weights in float32 with the 2:4 mask applied (what the program
    serves, worked out again from the dense weights)."""
    masked = {(node, leaf) for node, leaf in W.masked_paths(cfg, i)}

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        w = node.to(torch.float32)
        if (path[:-1], path[-1]) in masked:
            w = w.masked_fill_(W.nm_prune_mask(torch, node), 0.0)
        return w

    return walk(blk, ())
