"""Readings of the comparison on many seeds in one process, to set a cell's
limits (``limits/<cell>.json``) from: the program's, its lower-precision
control's, and a planted fault's. The benchmark's own runs never run this.

    python3 benchmark/calibrate.py --workload <cell> --mode <mode> --seeds 1,2,3 [--seconds 3]

Modes:
  * ``program``: the program as a run drives it (serving: a short window
    of ``--seconds`` at the cell's load, then the comparison; training:
    the three checked steps);
  * ``control``: the reference computed in float8 (e4m3, per-tensor
    scales, on every convolution's and linear layer's operands), with a
    plain greedy NMS, put in the program's place: the precision below the
    configuration's bfloat16;
  * ``bf16``: the same with bfloat16 operands, the configuration's own
    precision: what rounding alone gives (a look, not a limit);
  * a fault of ``FAULTS``, planted in the program, which then runs as in
    ``program``.

Prints one JSON line a seed, ``{"seed", "mode", "readings"}``; ``--out``
also appends them to a file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import common  # noqa: E402
from benchmark.harness.data import Batch, make_pool, upload  # noqa: E402


def serve_readings(ctx, mode: str):
    from benchmark.loops import serve
    from benchmark.reference import serve as ref_serve

    tr = ctx.cell.traffic
    pool = make_pool(ctx.cell.config, tr["batch"], tr["pool"], ctx.seed, ctx.dev, False)
    if mode in PRECISIONS:
        ref = common.reference_model(ctx.cell.config, ctx.seed, ctx.dev, PRECISIONS[mode])
        server = serve.Server(lambda b: ref_serve.test_forward(ref, Batch(*b)), ctx.dev)
        outs = [server.request(pool[i % len(pool)]) for i in range(tr["check"])]
        del ref, server
    else:
        with plant(mode, "serve"):
            model, server = serve.program_server(ctx)
            server.request(pool[0])
            outs, _, _, _ = serve.serve_window(server, pool, ctx.seconds)
        del model, server
    ctx.free()
    return serve.check(ctx, pool, outs, tr["check"])


def control_steps(ctx, pool, precision="fp8"):
    """The reference at ``precision`` and its Adagrad in the training
    step's place: the readings ``first_steps`` gives for the program."""
    import torch

    from benchmark.loops.train import CHECKED_STEPS, draws_for
    from benchmark.reference import serve as ref_serve
    from benchmark.reference.optim import Adagrad

    cfg = ctx.cell.config
    m = cfg["model"]
    ref = common.reference_model(cfg, ctx.seed, ctx.dev, precision)
    opt = Adagrad(ref.named_parameters(), cfg["optimizer"],
                  ("backbone",) if m["backbone_frozen"] else ())
    named = dict(ref.named_parameters())
    p0 = {n: p.detach().clone() for n, p in named.items()}
    losses, grad, props = [], {}, []
    for k in range(CHECKED_STEPS):
        batch = upload(pool[k % len(pool)], ctx.dev)
        with torch.no_grad():
            qry, spp = ref.extract(batch)
            cls, reg = ref.rpn(qry, spp)
            pb, ps, pv = ref_serve.proposals(ref, cls, reg, batch.img_hw,
                                             m["rpn_train_nms_pre"], m["rpn_train_max_per_img"])
        props.append((pb.cpu(), ps.cpu(), pv.cpu()))
        for p in named.values():
            p.grad = None
        out = ref.train_losses(batch, draws_for(ctx.seed, k, ctx.dev), pb, pv)
        total = sum(v for n, v in out.items() if n.startswith("loss_"))
        total.backward()
        losses.append(float(total.detach()))
        if k == 0:
            grad = {n: float(p.grad.norm()) if p.grad is not None else 0.0
                    for n, p in named.items()}
        opt.step()
    delta = {n: float((p.detach() - p0[n]).norm()) for n, p in named.items()}
    return {"losses": losses, "grad": grad, "delta": delta, "proposals": props}


PRECISIONS = {"control": "fp8", "bf16": "bf16"}


def half_batch(train_forward):
    """``train_forward`` on the first half of the batch's rows only."""
    def forward(self, batch, *a, **k):
        B = batch.qry_img.shape[0]
        return train_forward(self, type(batch)(*(
            t[:B // 2] if t.dim() and t.shape[0] == B else t for t in batch)), *a, **k)
    return forward


def _served(test_forward, kind):
    """``test_forward`` with its answers altered where they are produced."""
    def forward(self, batch):
        out = test_forward(self, batch)
        B = out["dt_scores"].shape[0]
        if kind == "half":  # half of the batch left unanswered
            for k in ("prop_valid", "dt_valid"):
                out[k][B // 2:] = False
            for k in ("proposals", "prop_scores", "dt_boxes", "dt_scores", "dt_mask_logits"):
                out[k][B // 2:] = 0
        elif kind == "score":
            out["dt_scores"][0, 0] += 0.3
        elif kind == "box":
            out["dt_boxes"][0, 0, 2:] += 0.5 * (out["dt_boxes"][0, 0, 2:] - out["dt_boxes"][0, 0, :2]) + 4.0
        elif kind == "mask":
            out["dt_mask_logits"][0, 0] += 3.0
        elif kind == "keep1":  # one detection an image kept
            out["dt_valid"][:, 1:] = False
            for k in ("dt_boxes", "dt_scores", "dt_mask_logits"):
                out[k][:, 1:] = 0
        return out
    return forward


def _lowest(nms, n_before_idx: int):
    """An NMS that keeps the lowest-scoring candidates (greedy over the
    negated scores) and reports their true scores."""
    def run(boxes, scores, *a, **k):
        import torch

        out = list(nms(boxes, -scores, *a, **k))
        idx, valid = out[n_before_idx].long(), out[-1]
        out[1] = torch.where(valid, torch.gather(scores, 1, idx), torch.zeros((), dtype=scores.dtype,
                                                                               device=scores.device))
        return tuple(out)
    return run


def _scaled_lr(build, factor: float):
    def build_optimizer(model, *a, roi_head_lr_mult: float = 0.1, **k):
        return build(model, *a, roi_head_lr_mult=roi_head_lr_mult * factor, **k)
    return build_optimizer


# The faults a cell can have, planted in the program. Serving: half of the
# batch unanswered; a score, a box or a mask altered; one detection kept
# an image; the lowest-scoring candidates kept at both NMS stages; greedy
# NMS (K2) suppressing above half its threshold; the pre-NMS top-k cut to
# a thirty-second. Training: a step that leaves its state unchanged; half
# of the batch left out; the RoI head not updated; the RoI head at ten
# times its learning rate; the lowest-scoring proposals kept; greedy NMS
# suppressing above half its threshold.
SERVE_FAULTS = ("half", "score", "box", "mask", "keep1", "lowest", "suppress", "topk")
TRAIN_FAULTS = ("unchanged", "half", "head_frozen", "head_lr10", "lowest", "suppress")
FAULTS = SERVE_FAULTS + tuple(f for f in TRAIN_FAULTS if f not in SERVE_FAULTS)


@contextlib.contextmanager
def plant(kind: str, loop: str):
    """The program with fault ``kind`` (or ``program``: none) while the
    context is open; ``loop``: ``serve`` or ``train``."""
    from fgn_torch.models import fgn
    from fgn_torch.train import optim

    if kind == "program":
        yield
        return
    if kind not in (SERVE_FAULTS if loop == "serve" else TRAIN_FAULTS):
        raise ValueError(f"mode {kind!r} is not for a {loop} cell")
    with contextlib.ExitStack() as stack:
        patch = lambda *a, **k: stack.enter_context(mock.patch.object(*a, **k))  # noqa: E731
        if loop == "serve" and kind in ("half", "score", "box", "mask", "keep1"):
            patch(fgn.FGN, "test_forward", _served(fgn.FGN.test_forward, kind))
        elif kind == "lowest":
            patch(fgn, "nms_padded", _lowest(fgn.nms_padded, 2))
            patch(fgn, "batched_nms", _lowest(fgn.batched_nms, 3))
        elif kind == "suppress":
            alive = fgn.greedy_alive_cuda
            patch(fgn, "greedy_alive_cuda", lambda b, a, thr, *r, **k: alive(b, a, thr * 0.5, *r, **k))
        elif kind == "topk":
            get = fgn.FGN.get_proposals
            patch(fgn.FGN, "get_proposals",
                  lambda self, c, r, hw, nms_pre, *a, **k: get(self, c, r, hw, nms_pre // 32, *a, **k))
        elif kind == "unchanged":
            patch(optim.FGNOptimizer, "step", lambda self, closure=None: None)
        elif kind == "half":
            patch(fgn.FGN, "train_forward", half_batch(fgn.FGN.train_forward))
        elif kind in ("head_frozen", "head_lr10"):
            patch(optim, "build_optimizer", _scaled_lr(
                optim.build_optimizer, 0.0 if kind == "head_frozen" else 10.0))
        yield


def train_readings(ctx, mode: str):
    from benchmark.loops import train

    tr = ctx.cell.traffic
    pool = make_pool(ctx.cell.config, tr["batch"], tr["pool"], ctx.seed, ctx.dev, True)
    if mode in PRECISIONS:
        prog = control_steps(ctx, pool, PRECISIONS[mode])
    else:
        with plant(mode, "train"):
            trainer = train.Trainer(ctx)
            prog = train.first_steps(trainer, pool)
        del trainer
    ctx.free()
    return train.check(ctx, pool, prog)


def readings(cell, seed: int, mode: str, seconds: float, dev):
    import torch

    ctx = common.Ctx(cell=cell, seed=seed, seconds=seconds, trace=False,
                     dev=torch.device(dev), t_start=time.time())
    fn = train_readings if cell.traffic["loop"] == "train" else serve_readings
    return fn(ctx, mode)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True, choices=("program",) + tuple(PRECISIONS) + FAULTS)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    common.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        common.log("calibrate: no CUDA device")
        return 2
    cell = common.Cell.load(args.workload)
    for s in args.seeds.split(","):
        t0 = time.time()
        r = readings(cell, int(s), args.mode, args.seconds, "cuda")
        line = json.dumps({"workload": args.workload, "seed": int(s), "mode": args.mode,
                           "readings": r, "s": time.time() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
