#!/usr/bin/env python3
"""Find where one float32 AdaGrad step on the card parts from the same step
on the CPU (chip_smoke.py's phase 7 check of run (e), which in about one run
of three sees one example's gradient differ).

Run from the repository root on a machine with a CUDA card:

    python3 chip_adagrad_isolate.py [tries [case_file]]

Each try repeats run (e) of chip_smoke.py (cached AdaGrad with the master
state, 34 steps at full width), then takes the float32 step on the last
batch on the card and on the CPU from the same state. When cache rows lie
more than chip_smoke.AG_BULK_TOL apart it runs the dense forward and backward
of that batch stage by stage on the card, on the CPU, and on the CPU in
float64 as the referee, finds the examples whose embedding gradient differs,
and for the worst of them prints every stage's distance from the referee,
the ReLU units whose mask differs between card and CPU with their
pre-activations, the side of the loss's clip that the probability falls on,
and the stage of the backward at which the gradients part. The example's
inputs and the parameters go to ``case_file`` (default: adagrad_case.pt in
the temporary directory). It stops at the first try that shows the
difference, or after ``tries`` (default 5) clean ones.
"""

from __future__ import annotations

import itertools
import os
import sys
import tempfile

import numpy as np
import torch

import chip_smoke as cs

REL_TOL = 1e-3  # an example's gradient differs when |card - cpu| > REL_TOL * |cpu|


def forward_stages(params, x, ly, targets, loss_function, dtype):
    """The dense forward of models/dlrm.py in ``dtype`` (float32 runs the
    same torch ops as the step does with no compute dtype), every stage
    kept: bottom pre-activations, the interaction's dot products, top
    pre-activations, the probability, the per-example loss. ``ly`` is the
    leaf the embedding gradient is taken at. Returns (stages, loss)."""
    from cdlrm_tpu_torch.models.dlrm import _EPS, _tril_flat_index

    stages = {}
    h = x.to(dtype)
    for i, (w, b) in enumerate(params["bot"]):
        pre = torch.matmul(h, w.to(dtype)) + b.to(dtype)
        stages[f"bot{i}.pre"] = pre
        h = torch.relu(pre)
    nb, nf = h.shape[0], ly.shape[0] + 1
    feats = torch.cat([h[None], ly], dim=0).permute(1, 0, 2)
    z = torch.matmul(feats, feats.transpose(1, 2))
    stages["interact.z"] = z
    r = torch.cat([h, z.reshape(nb, nf * nf)[:, _tril_flat_index(nf, False, z.device)]], dim=1)
    last = len(params["top"]) - 1
    for i, (w, b) in enumerate(params["top"]):
        pre = torch.matmul(r, w.to(dtype)) + b.to(dtype)
        stages[f"top{i}.pre"] = pre
        r = torch.sigmoid(pre) if i == last else torch.relu(pre)
    stages["p"] = r
    assert loss_function == "bce", loss_function
    t = targets.to(dtype)
    pc = torch.clamp(r, _EPS, 1.0 - _EPS)
    per_example = -(t * torch.log(pc) + (1.0 - t) * torch.log(1.0 - pc))
    stages["loss.per_example"] = per_example
    return stages, per_example.mean()


def run_stages(params, x, ly, targets, loss_function, dtype):
    """forward_stages with every stage's gradient kept: returns (stages,
    grads), ``grads[name]`` the loss's gradient at that stage and
    ``grads['ly']`` at the embeddings."""
    ly = ly.detach().to(dtype).requires_grad_()
    x = x.detach().to(dtype).requires_grad_()  # so that the bottom stages carry a gradient
    stages, loss = forward_stages(params, x, ly, targets, loss_function, dtype)
    names = [k for k in stages if k not in ("loss.per_example",)]
    got = torch.autograd.grad(loss, [stages[k] for k in names] + [ly])
    grads = dict(zip(names + ["ly"], got))
    return {k: v.detach() for k, v in stages.items()}, grads


def per_example_max(t: torch.Tensor, b_axis: int) -> torch.Tensor:
    """max |t| over every axis but the batch axis."""
    t = t.abs().double().cpu()
    axes = [a for a in range(t.dim()) if a != b_axis]
    return t.amax(dim=axes) if axes else t


def analyse(card, tr, inputs32, step_cfg, case_file: str) -> None:
    from cdlrm_tpu_torch.train import step as step_lib

    geo, dev = tr.geo, tr.device
    x, inv_wire, _mask, uniq_wire, uniq_counts = inputs32[:5]
    targets = inputs32[-1].to(torch.float32)
    offsets = torch.as_tensor(geo.table_offsets, dtype=torch.int32, device=dev)
    n_lk = cs.BATCH
    uniq_slots, ginv = step_lib._decode_dedup(
        inv_wire, uniq_wire, uniq_counts, offsets, geo.trash_row, step_cfg.inv_bits,
        step_cfg.uniq_bits, n_lk)
    # the step has staged this batch's miss rows already: the cache holds them
    rows = tr.cache.index_select(0, uniq_slots).index_select(0, ginv)
    ly = rows.reshape(cs.TABLES, cs.BATCH, cs.DIM)
    params = {k: v for k, v in tr.params.items()}
    loss_fn = tr.cfg.loss_function
    runs = {}
    for name, device, dtype in (("card", dev, torch.float32), ("cpu", "cpu", torch.float32),
                                ("f64", "cpu", torch.float64)):
        p = {k: [(w.to(device), b.to(device)) for w, b in v] for k, v in params.items()}
        runs[name] = run_stages(p, x.to(device), ly.to(device), targets.to(device), loss_fn,
                                dtype)
    (s_card, g_card), (s_cpu, g_cpu), (s_ref, g_ref) = runs["card"], runs["cpu"], runs["f64"]

    # which examples' embedding gradients differ between card and CPU
    d_ly = per_example_max(g_card["ly"].cpu() - g_cpu["ly"], 1)
    n_ly = per_example_max(g_cpu["ly"], 1)
    rel = d_ly / n_ly.clamp_min(1e-30)
    bad = torch.nonzero(rel > REL_TOL).flatten().tolist()
    order = torch.argsort(rel, descending=True)[:5].tolist()
    print(f"[{card}] embedding gradient, card vs CPU, per example: {len(bad)} of {cs.BATCH} "
          f"differ by more than {REL_TOL} of their size; the five largest ratios "
          + ", ".join(f"example {b}: {float(rel[b]):.3e}" for b in order))
    if not bad:
        print("no example's gradient differs in the stage-by-stage rerun: the difference "
              "is not in the dense forward and backward as rerun here")
        return
    for b in bad[:3]:
        print(f"--- example {b} (target {float(targets[b]):.0f}) ---")
        for name in s_ref:
            c = s_card[name].cpu().double()[b]
            u = s_cpu[name].double()[b]
            r = s_ref[name][b]
            line = (f"  forward {name}: |card-f64| {float((c - r).abs().max()):.3e} "
                    f"|cpu-f64| {float((u - r).abs().max()):.3e} "
                    f"|card-cpu| {float((c - u).abs().max()):.3e}")
            if name.endswith(".pre") and not name.startswith(f"top{len(params['top']) - 1}"):
                flip = torch.nonzero((c > 0) != (u > 0)).flatten().tolist()
                line += f"; ReLU masks that differ: {len(flip)}"
                for j in flip[:8]:
                    line += (f" [unit {j}: card {float(c[j]):.3e} cpu {float(u[j]):.3e} "
                             f"f64 {float(r[j]):.3e}]")
            print(line)
        p_c, p_u, p_r = (float(s["p"][b].double().cpu()) for s in (s_card, s_cpu, s_ref))
        eps = 1e-7
        print(f"  p: card {p_c!r} cpu {p_u!r} f64 {p_r!r}; the loss clips p to "
              f"[{eps}, {float(np.float32(1.0) - np.float32(eps))!r}]: card "
              f"{'inside' if eps < p_c < float(np.float32(1 - eps)) else 'AT THE CLIP'}, cpu "
              f"{'inside' if eps < p_u < float(np.float32(1 - eps)) else 'AT THE CLIP'}")
        for name in list(g_ref)[::-1]:
            axis = 1 if name == "ly" else 0
            sel = (slice(None), b) if axis == 1 else (b,)
            c = g_card[name].cpu().double()[sel]
            u = g_cpu[name].double()[sel]
            r = g_ref[name][sel]
            size = float(r.abs().max())
            print(f"  backward d/d {name}: size {size:.3e}; |card-f64| "
                  f"{float((c - r).abs().max()):.3e} |cpu-f64| {float((u - r).abs().max()):.3e} "
                  f"|card-cpu| {float((c - u).abs().max()):.3e}")
    b = bad[0]
    path = case_file
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"example": b, "x": x[b].cpu(), "ly": ly[:, b].cpu(), "target": targets[b].cpu(),
                "params": {k: [(w.cpu(), bb.cpu()) for w, bb in v] for k, v in params.items()}},
               path)
    print(f"example {b}'s inputs and the parameters saved to {path} "
          f"({os.path.getsize(path)} bytes)")


def one_try(card: str, dev: torch.device, attempt: int, case_file: str) -> bool:
    """Run (e), then the float32 step on card and CPU; True when it showed
    the difference (and was analysed)."""
    from cdlrm_tpu_torch.train import step as step_lib
    from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer

    cfg = cs.headline_config(
        lookahead=cs.LOOKAHEAD, print_freq=1 << 30, dedup_lookups="on",
        cache_size=cs.AG_CACHE_SETS, optimizer="adagrad", adagrad_master_state=True,
        learning_rate=cs.AG_LR, lr_embeds=cs.AG_LR, checkpoint_async=True,
    )
    total = cs.TRAIN_WARM_STEPS + cs.TRAIN_STEPS
    ds = cs.uniform_stream(cfg, total + cs.AG_RESUME_STEPS + 2 * cs.LOOKAHEAD, cs.SEED + 7)
    tr = CachedDlrmTrainer(cfg, ds, device=dev)
    try:
        tr.train(max_steps=total, log_fn=lambda *_: None)
        torch.cuda.synchronize()
        assert tr.eviction_manager.flush(timeout=120)
    finally:
        tr.close()
    batch = list(itertools.islice(ds.batches(), total))[-1]
    inputs, _, dedup, _ = tr._assemble(batch, cs.BATCH)
    assert dedup
    step_cfg = tr.step_cfg._replace(dedup=True, compute_dtype="float32")
    step32 = step_lib.make_cached_train_step(tr.geo, step_cfg, tr.pooled_width)
    inputs32 = (inputs[0].float(), *inputs[1:])
    # copies of the state: the step updates the cache and embed_acc in place,
    # and the analysis wants the state the step started from
    cache0 = tr.cache.clone()
    state_cpu = (cs._cpu_copy(tr.dense_acc), tr.embed_acc.to("cpu", copy=True))
    params_cpu, cache_cpu = cs._cpu_copy(tr.params), tr.cache.to("cpu", copy=True)
    _, c_dev, _, _, l_dev, _ = step32(tr.params, tr.cache, *inputs32, tr.dense_acc,
                                      tr.embed_acc.clone(), tr._lr, tr._lr_emb)
    _, c_cpu, _, _, l_cpu, _ = step32(params_cpu, cache_cpu, *[t.cpu() for t in inputs32],
                                      *state_cpu, tr._lr, tr._lr_emb)
    apart, worst, apart_rows = 0, 0.0, []
    chunk = 1 << 20
    for i in range(0, c_cpu.shape[0], chunk):
        diff = (c_dev[i: i + chunk].cpu() - c_cpu[i: i + chunk]).abs()
        worst = max(worst, float(diff.max()))
        rows_off = torch.nonzero((diff > cs.AG_BULK_TOL).any(dim=1)).flatten() + i
        apart += int(rows_off.numel())
        apart_rows += rows_off[:40].tolist()
    print(f"[{card}] try {attempt}: after the float32 AdaGrad step, card vs CPU: max |cache "
          f"difference| {worst:.3e}, {apart} cache rows more than {cs.AG_BULK_TOL} apart, "
          f"|loss difference| {abs(float(l_dev) - float(l_cpu)) / cs.BATCH:.3e}")
    if apart == 0:
        return False
    # the rows apart: their row-wise state before the step, and how far the
    # step moved them on either side
    sel = torch.tensor(apart_rows[:40])
    acc0 = tr.embed_acc[sel.to(dev)].cpu()
    moved_dev = (c_dev[sel.to(dev)].cpu() - cache0[sel.to(dev)].cpu()).abs().amax(dim=1)
    moved_cpu = (c_cpu[sel] - cache0[sel.to(dev)].cpu()).abs().amax(dim=1)
    print(f"[{card}] rows apart (first 40 of {apart}): "
          + "; ".join(f"row {int(r)}: state before {float(a):.3e}, moved card "
                      f"{float(md):.3e} cpu {float(mc):.3e}"
                      for r, a, md, mc in zip(sel, acc0, moved_dev, moved_cpu)))
    # back to the state the step started from (the aux rows of this batch
    # are staged into it again by the same values)
    tr.cache.copy_(cache0)
    step_lib._stage_aux(tr.cache, inputs32[5], inputs32[6], tr.geo.trash_row)
    analyse(card, tr, inputs32, step_cfg, case_file)
    return True


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_adagrad_isolate: no CUDA device", file=sys.stderr)
        return 1
    tries = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    case_file = (sys.argv[2] if len(sys.argv) > 2
                 else os.path.join(tempfile.gettempdir(), "adagrad_case.pt"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card)
    for attempt in range(1, tries + 1):
        if one_try(card, dev, attempt, case_file):
            print(f"shown in try {attempt} of {tries}")
            return 0
        torch.cuda.empty_cache()
    print(f"not shown in {tries} tries")
    return 0


if __name__ == "__main__":
    sys.exit(main())
