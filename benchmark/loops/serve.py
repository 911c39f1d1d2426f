"""Closed-loop serving with one client: each request is one episode batch,
taken in turn from a pool of distinct seeded batches in pinned host
memory, uploaded, run through ``FGN.test_forward``, and its outputs
copied back to the host. The next request is sent when the last one's
outputs are on the host.

Traffic parameters (``traffic/<name>.json``): ``batch`` queries a request,
``pool`` distinct batches, ``warmup`` requests before the window,
``check`` requests compared with the reference after it, ``profile``
requests in the traced stretch.

End-to-end: ``serve_imgs_s`` is every query image of the requests
completed in the window over the window's seconds (it closes when the
first request finishing after ``--seconds`` is on the host);
``serve_p95_ms`` the 95th percentile of every request's time from taking
its batch from the pool to its outputs on the host.
"""

from __future__ import annotations

import random
import statistics
import time

import torch

from benchmark.harness import common, compare, flops, trace
from benchmark.harness.common import log
from benchmark.harness.data import make_pool, mix, upload

KEYS = ("proposals", "prop_scores", "prop_valid", "dt_boxes", "dt_scores",
        "dt_cats", "dt_valid", "dt_mask_logits")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.current_stream().synchronize()


class Server:
    """The program behind the client: ``forward(batch)`` → outputs on the
    device. The calibration and the tests put other forwards here."""

    def __init__(self, forward, dev):
        from fgn_torch.data.batching import EpisodeBatch

        self.forward = forward
        self.dev = dev
        self.episode = EpisodeBatch
        self.host = None

    def request(self, pinned):
        b = upload(pinned, self.dev)
        out = self.forward(self.episode(*b))
        if self.host is None:
            pin = self.dev.type == "cuda"
            self.host = {k: torch.empty(out[k].shape, dtype=out[k].dtype,
                                        pin_memory=pin) for k in KEYS}
        for k in KEYS:
            self.host[k].copy_(out[k], non_blocking=True)
        _sync(self.dev)
        return {k: v.clone() for k, v in self.host.items()}


def serve_window(server: Server, pool, seconds: float):
    """→ (outputs of each request, latencies in s, images, window s)."""
    nb = pool[0].qry_img.shape[0]
    outs, lat = [], []
    t_open = time.perf_counter()
    deadline = t_open + seconds
    now = t_open
    while now < deadline:
        t0 = time.perf_counter()
        outs.append(server.request(pool[len(outs) % len(pool)]))
        now = time.perf_counter()
        lat.append(now - t0)
    return outs, lat, nb * len(outs), now - t_open


def check(ctx, pool, outs, n_check: int, forget=None):
    """The comparison over a seeded sample of the window's requests, each
    of another pool batch where there are enough. → readings (the largest
    of each number over the sample)."""
    if forget is not None:
        forget()
    order = list(range(len(outs)))
    random.Random(mix(ctx.seed, "check")).shuffle(order)
    picked, seen = [], set()
    for i in order:
        if i % len(pool) not in seen or len(seen) >= len(pool):
            picked.append(i)
            seen.add(i % len(pool))
        if len(picked) == n_check:
            break
    ref = common.reference_model(ctx.cell.config, ctx.seed, ctx.dev)
    worst = {}
    for i in picked:
        batch = upload(pool[i % len(pool)], ctx.dev)
        out = {k: v.to(ctx.dev) for k, v in outs[i].items()}
        r = compare.serve_readings(ref, ctx.cell.config, batch, out)
        log(f"check: request {i} (pool {i % len(pool)}): "
            + ", ".join(f"{k} {v:.6g}" for k, v in r.items()))
        for k, v in r.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def program_server(ctx):
    model = common.program_model(ctx.cell.config, ctx.seed, ctx.dev).eval()
    if ctx.dev.type == "cuda":
        from fgn_torch.ops import _build

        _build.load_all()
    return model, Server(model.test_forward, ctx.dev)


def run(ctx) -> common.Outcome:
    tr = ctx.cell.traffic
    nb = tr["batch"]
    ctx.mark("imports")
    model, server = program_server(ctx)
    ctx.mark("model and kernels")
    pool = make_pool(ctx.cell.config, nb, tr["pool"], ctx.seed, ctx.dev, with_gt=False)
    ctx.mark("pool")
    for i in range(tr["warmup"]):
        server.request(pool[i % len(pool)])
    ctx.mark("warm-up")
    ctx.card("window opens")
    setup_s = time.time() - ctx.t_start
    outs, lat, imgs, window_s = serve_window(server, pool, ctx.seconds)
    ctx.card("window closes")
    peak = ctx.peak_bytes()
    note = (f"serve: {len(outs)} requests of {nb} in {window_s!r} s; latency "
            f"median {statistics.median(lat) * 1e3!r} ms, p95 "
            f"{common.quantile(lat, 0.95) * 1e3!r} ms over {len(lat)} samples")
    log(note)
    failed = sum(1 for o in outs if not all(bool(torch.isfinite(o[k].float()).all())
                                            for k in ("dt_boxes", "dt_scores", "dt_mask_logits")))
    metrics = {"serve_imgs_s": imgs / window_s,
               "serve_p95_ms": common.quantile(lat, 0.95) * 1e3,
               "setup_s": setup_s}
    rec = None
    if ctx.trace:
        rec = trace.Records()
        rec.rate_imgs_s = imgs / window_s
        rec.flops_per_img = flops.serve_flops_per_img(ctx.cell.config, nb)
        if ctx.dev.type == "cuda":
            p = flops.peaks(torch.cuda.get_device_name(ctx.dev))
            rec.peak_flops, rec.hbm_bytes_s = p["bf16"], p["hbm"]

        def units(r):
            for i in range(tr["profile"]):
                with torch.profiler.record_function("bench/unit"):
                    server.request(pool[i % len(pool)])
                if r is not None:
                    r.units += 1

        trace.profile(units, ctx.spans, rec, ctx.nodes)

    def forget():
        nonlocal model, server
        del model, server
        ctx.free()

    readings = check(ctx, pool, outs, tr["check"], forget)
    return common.Outcome(metrics=metrics, attempted=len(outs), failed=failed,
                          readings=readings, rec=rec, peak_bytes=peak, notes=[note])
