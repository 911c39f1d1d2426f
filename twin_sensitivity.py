#!/usr/bin/env python3
"""Where the f32 training step's gradient amplifies RoIAlign's rounding.

    python3 twin_sensitivity.py            # flagship geometry, b2, on the GPU
    python3 twin_sensitivity.py --cpu --small   # a toy geometry on the CPU

``chip_smoke.py``'s f32 training twin holds every parameter's gradient
through the kernels against the same step through the plain versions. This
script measures how far that gradient moves when only the order in which
RoIAlign's forward sums its corners changes, with no kernel involved: one
``train_forward`` + backward (f32, TF32 off, deterministic cuDNN) through
the plain versions, then again with the plain forward replaced by another
plain version of the same function (``_roi_align_separable``, the staged
kernel's order; the gather form ``ops/roi_align.py``), and with the staged
kernel's forward on the GPU. The backward is the plain version in every
run, so the forward is the only difference.

For each run against the first it prints RoIAlign's output difference, the
parameters whose gradient moved most (relative to the leaf's largest
entry), and, for every module call after RoIAlign in forward order, the
relative difference of its output and of the gradient of its output, and
how many output elements changed sign (the inputs of the ReLUs that
follow). The first call, walking back from the loss, whose output gradient
moves far more than its output, is the amplifier. For each GroupNorm call
it also prints the spread (std) of the input of the group that holds the
largest change of the output gradient, beside the median group's.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import sys
from unittest import mock


def rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--small", action="store_true",
                    help="64 px queries, 32 px supports, 8 sampled ROIs")
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("twin_sensitivity: no CUDA device (use --cpu)", file=sys.stderr)
        return 2
    import fgn_torch.models.fgn as fgn_mod
    import fgn_torch.ops.roi_align_cuda as rac
    from fgn_torch.config import FGNConfig
    from fgn_torch.data.batching import to_device, toy_batch
    from fgn_torch.ops.nms import _greedy_alive
    from fgn_torch.ops.roi_align import roi_align as gather_roi_align
    from fgn_torch.train.train_step import total_loss

    dev = torch.device("cpu" if args.cpu else "cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    kw = dict(n_ways=3, k_shots=3, backbone_norm="gn", backbone_frozen=False,
              compute_dtype="float32")
    if args.small:
        kw.update(rpn_train_nms_pre=64, rpn_train_max_per_img=16,
                  rcnn_num_samples=8, k_shots=1)
    cfg = FGNConfig(**kw)
    model = fgn_mod.build_model(cfg, dev, seed=0)
    geo = (dict(H=64, W=64, S=32) if args.small
           else dict(H=480, W=480, S=128))
    batch = to_device(toy_batch(B=2, N=3, K=cfg.k_shots, **geo), dev)

    def plain_bwd(g, rois, H, W, *a):
        return rac._roi_align_plain_bwd(g, rois, H, W, g.dtype, *a)

    def gather_fwd(fmap, rois, O, scale, S, aligned):
        return gather_roi_align(fmap, rois, O, spatial_scale=scale,
                                sampling_ratio=S, aligned=aligned)

    forwards = {"plain": rac._roi_align_plain,
                "separable": rac._roi_align_separable,
                "gather": gather_fwd}
    if dev.type == "cuda":
        forwards["staged kernel"] = rac._roi_align_forward

    after = ("shared5.", "rel_", "fc_", "mask_")

    def run(fwd):
        recs = collections.OrderedDict()
        calls = collections.Counter()
        k1 = []
        handles = []
        for name, m in model.named_modules():
            if list(m.children()) or not name.startswith(after):
                continue

            def hook(mod, inp, out, name=name):
                key = f"{name}#{calls[name]}"
                calls[name] += 1
                rec = recs[key] = {"out": out.detach().clone(), "mod": mod}
                if isinstance(mod, fgn_mod.GroupNorm):
                    rec["in"] = inp[0].detach().float().clone()
                if out.requires_grad:
                    out.register_hook(
                        lambda g, rec=rec: rec.__setitem__("grad", g.detach().clone()))
            handles.append(m.register_forward_hook(hook))

        def fwd_rec(*a):
            out = fwd(*a)
            k1.append(out.detach().clone())
            return out

        with contextlib.ExitStack() as st:
            st.enter_context(mock.patch.object(rac, "_roi_align_forward", fwd_rec))
            st.enter_context(mock.patch.object(rac, "roi_align_backward_cuda",
                                               plain_bwd))
            st.enter_context(mock.patch.object(fgn_mod, "greedy_alive_cuda",
                                               _greedy_alive))
            model.zero_grad(set_to_none=True)
            gen = torch.Generator(device=dev).manual_seed(0)
            losses = model.train_forward(batch, gen)
            total_loss(losses).backward()
        for h in handles:
            h.remove()
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        return recs, grads, k1

    base_recs, base_grads, base_k1 = run(forwards.pop("plain"))
    print(f"device {dev}; {len(base_k1)} RoIAlign calls: "
          + ", ".join(str(tuple(o.shape)) for o in base_k1), flush=True)
    for tag, fwd in forwards.items():
        recs, grads, k1 = run(fwd)
        print(f"\n== {tag} forward against the plain forward", flush=True)
        print("RoIAlign output, max diff / scale: " + ", ".join(
            f"{rel(a, b):.3g}" for a, b in zip(k1, base_k1)))
        worst = sorted(((rel(grads[n], base_grads[n]), n) for n in base_grads),
                       reverse=True)
        print(f"gradients: {sum(e <= 1e-4 for e, _ in worst)}/{len(worst)} "
              "leaves within 1e-4 of scale; worst " + ", ".join(
                  f"{n} {e:.3g}" for e, n in worst[:args.top]))
        print("module call: output diff / scale, output-gradient diff / "
              "scale, outputs that changed sign")
        for key, b in base_recs.items():
            a = recs.get(key)
            if a is None or "grad" not in a or "grad" not in b:
                continue
            flips = int(((a["out"] > 0) != (b["out"] > 0)).sum())
            line = (f"  {key}: out {rel(a['out'], b['out']):.3g}, grad "
                    f"{rel(a['grad'], b['grad']):.3g}, sign flips {flips}")
            mod = b["mod"]
            if isinstance(mod, fgn_mod.GroupNorm):
                # the group holding the largest change of the output gradient
                x = b["in"]
                n, c = x.shape[:2]
                gsz = c // mod.num_groups
                d = (a["grad"] - b["grad"]).abs().reshape(n, mod.num_groups, -1)
                i = int(d.amax(-1).flatten().argmax())
                inst, grp = divmod(i, mod.num_groups)
                xs = x.reshape(n, mod.num_groups, -1)
                w = mod.weight.detach()[grp * gsz:(grp + 1) * gsz]
                line += (f"; largest change in instance {inst} group {grp}: "
                         f"input std {float(xs[inst, grp].std()):.3g} "
                         f"(median group {float(xs.std(-1).median()):.3g}), "
                         f"|gamma| max {float(w.abs().max()):.3g}")
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
