"""The episode engine's output, stage by stage, against a committed reference.

The port's engine and the JAX package's give the same bytes from the same
config and seed: the same glyphs, generated images and pickles, databags
and support banks, episodes and collated batch. ``digest_table`` runs an
engine through those stages and digests each output (sha256 of a canonical
form: dtype, shape and bytes of every array, the repr of every scalar; not
pickle bytes, which differ between numpy versions).

``reference/`` beside this file holds what the JAX package's engine gives
on a host with OpenCV 5.0: the digest table (``episode_digests.json``), the
generated split it was made from (``mnistiseg/``), the glyph bank
(``glyphs.npz``) and the image and mask arrays of the train episodes
(``train_episodes.npz``). The CPU tests regenerate all of it from the JAX
package and assert it equal. ``chip_smoke.py`` holds the port on the GPU's
host to it stage by stage (``check_stages``).

Three OpenCV calls of the engine give other bytes under OpenCV 4.x than
under 5.0 (``cv2_calls`` shows them on fixed inputs): ``putText`` renders
other outlines for the Hershey fonts, and ``warpAffine`` and ``remap`` with
bilinear interpolation round differently. So a host with OpenCV 4.x renders
other glyphs and generates another split. Their shapes differ too much for
a tolerance (the ink of a glyph can overlap the reference glyph's by a few
percent), so the glyph bank and this host's split are held to their
structure (``glyph_structure``, ``split_structure``) and the stages after
generation are checked on the committed split: the databags and the eval
episodes (no warps) byte for byte, the train episodes (augmentation warps
every image) and their batch within ``TOLERANCE``.

An engine is any object with the attributes ``Config``, ``GlyphBank``,
``MNISTISEG``, ``Augmenter``, ``init_ds_class_by_config`` and
``collate_episodes`` (see ``port_engine``).
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import shutil
import time
from types import SimpleNamespace
from typing import Dict, List, Sequence, Tuple

import numpy as np

REF_DIR = os.path.join(os.path.dirname(__file__), "reference")
TABLE_FP = os.path.join(REF_DIR, "episode_digests.json")
SPLIT_DIR = os.path.join(REF_DIR, "mnistiseg")
GLYPHS_FP = os.path.join(REF_DIR, "glyphs.npz")
EPISODES_FP = os.path.join(REF_DIR, "train_episodes.npz")
STAGES = ("cv2_calls", "glyph_bank", "raw_images", "databag",
          "train_episodes", "eval_episodes", "batch")
# The config the table is made from, relative to the package's root, and the
# generated split: 96 train and 80 val MNISTISEG images at seed 8.
CONFIG = os.path.join("configs", "fgn_train_mnistiseg_n3k3.py")
QUANTITIES = {"train": 96, "val": 80}
SEED = 8
N_EPISODES = 8
# The fields of an episode that the augmentation's warps reach.
WARPED = ("qry_img", "spp_imgs", "qry_isegmaps", "spp_isegmaps")
# OpenCV calls whose bytes depend on OpenCV's version (fixed-input names of
# ``cv2_calls``).
VERSION_DEPENDENT = ("putText", "warpAffine_linear_u8",
                     "warpAffine_linear_u8c3", "remap_linear_u8")
# The largest share of a generated split's instances whose color-keyed mask
# is empty. Under OpenCV 4.x some glyphs come out faint enough that no pixel
# of their paste lies within the keying margin of its color; OpenCV 5.0
# gives none at the reference's seed.
EMPTY_MASK_SHARE = 0.05
# Per warped field: the largest absolute difference, and the largest shares
# of elements that differ at all and by more than one (uint8 codes, or mask
# values). A bilinear warp rounds its sample positions and weights
# differently under OpenCV 4.x and 5.0; a nearest-neighbour warp picks
# another pixel where a position falls on a tie.
_IMG = dict(max_abs=12.0, share=0.05, share_over_1=0.005)
TOLERANCE = {
    "qry_img": _IMG, "spp_imgs": _IMG,
    "qry_isegmaps": dict(max_abs=1 / 32, share=1.0, share_over_1=0.0),
    "spp_isegmaps": dict(max_abs=1.0, share=1e-3, share_over_1=0.0),
    # the batch: soft query masks as uint8 codes (255 = 1), support masks
    # 0 or 255
    "batch:qry_img": _IMG, "batch:spp_imgs": _IMG,
    "batch:qry_masks": dict(max_abs=8.0, share=1.0, share_over_1=1.0),
    "batch:spp_masks": dict(max_abs=255.0, share=1e-3, share_over_1=1e-3),
}


def port_engine() -> SimpleNamespace:
    from fgn_torch.config import Config
    from fgn_torch.data.augment import Augmenter
    from fgn_torch.data.batching import collate_episodes
    from fgn_torch.data.fst_bindings import init_ds_class_by_config
    from fgn_torch.data.mnistiseg import MNISTISEG
    from fgn_torch.data.synth import GlyphBank

    return SimpleNamespace(
        Config=Config, GlyphBank=GlyphBank, MNISTISEG=MNISTISEG,
        Augmenter=Augmenter, init_ds_class_by_config=init_ds_class_by_config,
        collate_episodes=collate_episodes)


# -- digests -----------------------------------------------------------------


def _feed(h, x) -> None:
    if isinstance(x, dict):
        h.update(b"{")
        for k in sorted(x, key=repr):
            _feed(h, k)
            _feed(h, x[k])
        h.update(b"}")
    elif isinstance(x, (list, tuple)):
        h.update(f"{type(x).__name__}{len(x)}[".encode())
        for v in x:
            _feed(h, v)
        h.update(b"]")
    elif isinstance(x, np.ndarray):
        h.update(f"array{x.dtype.str}{x.shape}".encode())
        if x.dtype == object:
            _feed(h, x.ravel().tolist())
        else:
            h.update(np.ascontiguousarray(x).tobytes())
    elif isinstance(x, np.generic):
        h.update(f"scalar{x.dtype.str}".encode() + x.tobytes())
    elif x is None or isinstance(x, (bool, int, float, str, bytes)):
        h.update(f"{type(x).__name__}:{x!r};".encode())
    else:
        raise TypeError(f"cannot digest a {type(x).__name__}")


def digest(x) -> str:
    """sha256 of ``x`` in the canonical form."""
    h = hashlib.sha256()
    _feed(h, x)
    return h.hexdigest()


def _file_digest(fp: str) -> str:
    with open(fp, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def cv2_calls() -> Dict[str, np.ndarray]:
    """Every OpenCV call the engine makes, on fixed inputs (seeded)."""
    import cv2

    rng = np.random.RandomState(0)
    out = {}
    glyph = np.full((72, 72), 255, np.uint8)
    cv2.putText(glyph, "3", (12, 52), cv2.FONT_HERSHEY_SIMPLEX, 1.6, 0, 2,
                cv2.LINE_AA)
    out["putText"] = glyph
    g = np.full((60, 40), 255, np.uint8)
    g[10:50, 8:32] = rng.randint(0, 256, (40, 24))
    out["resize_linear_u8"] = cv2.resize(g, (93, 139))
    out["copyMakeBorder_constant"] = cv2.copyMakeBorder(
        g, 20, 20, 20, 20, cv2.BORDER_CONSTANT, value=255)
    out["erode"] = cv2.erode(g, np.ones((3, 3), np.uint8))
    out["dilate"] = cv2.dilate(g, np.ones((2, 2), np.uint8))
    m = cv2.getRotationMatrix2D((30.0, 20.0), 13.7, 1.0)
    out["getRotationMatrix2D"] = m
    out["warpAffine_linear_u8"] = cv2.warpAffine(
        g, m, (40, 60), flags=cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_CONSTANT, borderValue=255)
    f = rng.uniform(-5, 5, (4, 4)).astype(np.float32)
    out["resize_linear_f32"] = cv2.resize(f, (40, 60))
    xs, ys = np.meshgrid(np.arange(40, dtype=np.float32),
                         np.arange(60, dtype=np.float32))
    d = rng.uniform(-3, 3, (2, 60, 40)).astype(np.float32)
    out["remap_linear_u8"] = cv2.remap(
        g, xs + d[0], ys + d[1], cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_CONSTANT, borderValue=255)
    img = rng.randint(0, 256, (128, 96, 3)).astype(np.uint8)
    img[::3] = 255
    out["dilate_mask"] = cv2.dilate((img[..., 0] > 128).astype(np.uint8),
                                    np.ones((3, 3), np.uint8))
    out["imencode_jpg"] = cv2.imencode(".jpg", img)[1]
    out["imdecode_jpg"] = cv2.imdecode(out["imencode_jpg"], cv2.IMREAD_COLOR)
    out["resize_linear_u8c3"] = cv2.resize(img, (77, 101))
    mk = (rng.rand(128, 96, 5) > 0.5).astype(np.uint8)
    out["resize_nearest_u8c5"] = cv2.resize(
        mk, (90, 120), interpolation=cv2.INTER_NEAREST)
    fm = rng.rand(32, 24, 5).astype(np.float32)
    out["resize_linear_f32c5"] = cv2.resize(fm, (22, 30))
    out["copyMakeBorder_reflect101"] = cv2.copyMakeBorder(
        img, 3, 5, 7, 2, cv2.BORDER_REFLECT_101)
    a = np.array([[1.05, 0.1, -3.2], [-0.07, 0.96, 4.4]])
    out["warpAffine_linear_u8c3"] = cv2.warpAffine(
        img, a, (96, 128), flags=cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_REPLICATE)
    out["warpAffine_nearest_u8c5"] = cv2.warpAffine(
        mk, a, (96, 128), flags=cv2.INTER_NEAREST,
        borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    out["warpAffine_linear_f32c5"] = cv2.warpAffine(
        fm, a, (24, 32), flags=cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    noise = np.round(rng.standard_normal(img.size) * 4).astype(np.int16)
    out["add_saturate"] = cv2.add(img, noise.reshape(img.shape),
                                  dtype=cv2.CV_8U)
    out["GaussianBlur"] = cv2.GaussianBlur(img, (0, 0), 0.87)
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    out["cvtColor_rgb2hsv"] = hsv.copy()
    hsv[..., 0] = cv2.LUT(hsv[..., 0],
                          ((np.arange(256) + 37) % 180).astype(np.uint8))
    out["LUT"] = hsv.copy()
    out["cvtColor_hsv2rgb"] = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
    mf = (rng.rand(97, 123) > 0.5).astype(np.float32)
    out["resize_area_f32"] = cv2.resize(mf, (30, 24),
                                        interpolation=cv2.INTER_AREA)
    poly = np.zeros((64, 64), np.uint8)
    cv2.fillPoly(poly, [np.array([[3, 4], [50, 10], [40, 60], [10, 40]],
                                 np.int32)], 1)
    out["fillPoly"] = poly
    return out


def glyph_pools(engine) -> Dict[str, list]:
    cls = engine.MNISTISEG
    return engine.GlyphBank(list(cls.chars), cls.variants_per_subset).pools


def ink_iou(got: np.ndarray, want: np.ndarray) -> float:
    """Intersection over union of two glyphs' ink (pixels below 128)."""
    a, b = got < 128, want < 128
    return float((a & b).sum() / max((a | b).sum(), 1))


def glyph_structure(engine, pools, ref: Dict[str, np.ndarray]) -> List[str]:
    """What is wrong with a glyph bank, whatever OpenCV drew: each subset's
    pool holds ``variants_per_subset`` glyphs of every character in order,
    each the reference glyph's shape and dtype, on a white canvas, with ink
    that stays off the canvas's border. → the faults, empty if none."""
    cls = engine.MNISTISEG
    bad = []
    for subset, n_var in cls.variants_per_subset.items():
        pool = pools.get(subset, [])
        cats = [ci for ci, _ in pool]
        if cats != [ci for ci in range(len(cls.chars)) for _ in range(n_var)]:
            bad.append(f"{subset}: categories {cats}")
        for k, (_, glyph) in enumerate(pool):
            key = f"{subset}:{k:03}"
            want = ref.get(key)
            if want is None or glyph.shape != want.shape \
                    or glyph.dtype != want.dtype:
                bad.append(f"{key}: {glyph.dtype}{glyph.shape}")
                continue
            ink = glyph < 128
            edge = np.concatenate([glyph[0], glyph[-1], glyph[:, 0],
                                   glyph[:, -1]])
            if not ink.any() or (edge != 255).any():
                bad.append(f"{key}: {int(ink.sum())} ink pixels, "
                           f"{int((edge != 255).sum())} on the border")
    if set(pools) != set(cls.variants_per_subset):
        bad.append(f"subsets {sorted(pools)}")
    return bad


def split_structure(engine, root: str, quantities: Dict[str, int]
                    ) -> Tuple[List[str], int, int]:
    """What is wrong with a generated split, whatever OpenCV drew: per
    subset, ``quantities`` images of ``img_size`` squared and three pickles
    of as many entries; per image, 2 to Σ(n - 1) instances over the size
    classes' quotas n (``create_ds`` draws ``randint(0, n)`` pastes a class
    and keeps images with 2 or more), category ids among the characters',
    boxes inside the image, a distinct color each, every color-keyed mask
    inside its box and at least one of them non-empty; over the split, at
    most ``EMPTY_MASK_SHARE`` of the instances with an empty mask. → (the
    faults, empty if none; the instances; those with an empty mask)."""
    cls = engine.MNISTISEG
    most = sum(max(n - 1, 0) for n in cls.sizes_max_amount.values())
    size = cls.img_size
    bad = []
    n_inst = n_empty = 0
    for subset, n in quantities.items():
        ds = cls(subset, root)
        lens = {len(ds.imgs_sps), len(ds.bboxes), len(ds.cat_ids),
                len(ds.colors)}
        if lens != {n}:
            bad.append(f"{subset}: {sorted(lens)} images or pickle entries, "
                       f"want {n}")
            continue
        for i in range(n):
            item = ds[i]
            boxes, cats = item["bboxes"], item["cat_ids"]
            colors = np.asarray(ds.colors[i]).reshape(len(boxes), -1)
            where = f"{subset}/{ds.imgs_sps[i]}"
            if item["img"].shape != (size, size, 3):
                bad.append(f"{where}: image {item['img'].shape}")
            if not 2 <= len(boxes) <= most or len(cats) != len(boxes):
                bad.append(f"{where}: {len(boxes)} boxes, {len(cats)} ids")
                continue
            if not all(0 <= c < len(cls.chars) for c in cats.tolist()):
                bad.append(f"{where}: category ids {cats.tolist()}")
            if len({tuple(c) for c in colors.tolist()}) != len(boxes):
                bad.append(f"{where}: colors {colors.tolist()}")
            empty = 0
            for j, (y0, x0, y1, x1) in enumerate(boxes.astype(int).tolist()):
                m = item["isegmaps"][j]
                outside = m.copy()
                outside[max(y0, 0):y1, max(x0, 0):x1] = 0
                if not (0 <= y0 < y1 <= size and 0 <= x0 < x1 <= size) \
                        or outside.any():
                    bad.append(f"{where}: instance {j}, box "
                               f"{[y0, x0, y1, x1]}, {int(outside.sum())} "
                               f"mask pixels outside")
                empty += not m.any()
            if empty == len(boxes):
                bad.append(f"{where}: every mask empty")
            n_inst += len(boxes)
            n_empty += empty
    if n_empty > EMPTY_MASK_SHARE * n_inst:
        bad.append(f"{n_empty} of {n_inst} masks empty")
    return bad, n_inst, n_empty


def glyph_digests(pools) -> Dict[str, str]:
    return {f"{subset}:{k:03}": digest(item)
            for subset, pool in pools.items() for k, item in enumerate(pool)}


def raw_digests(root: str, subsets: Sequence[str]) -> Dict[str, str]:
    """Every generated image (its file's bytes, and its decoded pixels) and
    every pickle (its content)."""
    import cv2

    from fgn_torch.utils.io import read_pkl

    out = {}
    for subset in subsets:
        for name in sorted(os.listdir(os.path.join(root, subset))):
            fp = os.path.join(root, subset, name)
            out[f"{subset}/{name}"] = _file_digest(fp)
            out[f"{subset}/{name}:pixels"] = digest(cv2.imread(fp))
        for what in ("bboxes", "cat_ids", "colors"):
            name = f"{subset}_{what}.pkl"
            out[name] = digest(read_pkl(os.path.join(root, name)))
    return out


def dataset_digests(ds, tag: str) -> Dict[str, str]:
    """The databag's content and the support bank's arrays."""
    out = {f"{tag}:databag": digest({
        "qrys_parents_": ds.qrys_parents_, "qrys_children": ds.qrys_children,
        "insts": ds.insts, "cats_insts_list": ds.cats_insts_list})}
    out[f"{tag}:len"] = digest(len(ds))
    bank = ds._spp_bank or {}
    for k in ("imgs", "masks", "bboxes"):
        if k in bank:
            out[f"{tag}:spp_bank_{k}"] = digest(np.asarray(bank[k]))
    return out


def draw_episodes(ds, n: int) -> List[Dict]:
    """Episodes 0..n-1, each drawn after seeding Python's and numpy's
    global generators with its index."""
    samples = []
    for i in range(n):
        random.seed(i)
        np.random.seed(i)
        samples.append(ds[i])
    return samples


def episode_digests(samples: Sequence[Dict]) -> Dict[str, str]:
    return {f"{i}:{k}": digest(v)
            for i, s in enumerate(samples) for k, v in s.items()}


def batch_digests(batch, meta) -> Dict[str, str]:
    out = {f"batch:{k}": digest(np.asarray(v))
           for k, v in batch._asdict().items()}
    out.update({f"meta:{k}": digest(v) for k, v in meta._asdict().items()})
    return out


def digest_table(engine, package_root: str, work: str, raw: str = ""):
    """Run ``engine`` through every stage: generate the split into
    ``work`` (or take the split at ``raw``), build the config's train and
    eval datasets over it, draw their episodes and collate the train
    episodes. → (the table, the built objects: ``cfg``, ``pools`` (the
    glyph bank), ``raw``, the datasets ``train`` and ``val``, their
    episodes ``train_eps`` and ``eval_eps``, ``batch`` and ``meta``, and
    ``seconds`` of generation, of each dataset's databag and support bank,
    and of drawing the episodes, on the host's clock)."""
    sec = {}
    # The augmenter's noise banks live on its class and are regrown, with
    # other contents, for the largest image the process has seen: start
    # from a fresh process's state.
    engine.Augmenter._NOISE_BANK = engine.Augmenter._UNIF_BANK = None
    cfg = engine.Config.from_file(os.path.join(package_root, CONFIG))
    if not raw:
        raw = os.path.join(work, "mnistiseg")
        t0 = time.perf_counter()
        engine.MNISTISEG.create(root=raw, quantities=dict(QUANTITIES),
                                seed=SEED)
        sec["generate"] = time.perf_counter() - t0
    roots = dict(inner_root=raw, root=os.path.join(work, "fst"))
    t0 = time.perf_counter()
    train = engine.init_ds_class_by_config(dict(cfg.train_ds_cfg, **roots))
    sec["train_dataset"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    val = engine.init_ds_class_by_config(dict(cfg.eval_ds_cfg0, **roots))
    sec["eval_dataset"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_eps = draw_episodes(train, N_EPISODES)
    eval_eps = draw_episodes(val, N_EPISODES)
    sec["episodes"] = time.perf_counter() - t0
    batch, meta = engine.collate_episodes(
        train_eps, train.mean, train.std, max_gt=int(cfg.max_gt))
    pools = glyph_pools(engine)
    table = {
        "cv2_calls": {k: digest(v) for k, v in cv2_calls().items()},
        "glyph_bank": glyph_digests(pools),
        "raw_images": raw_digests(raw, QUANTITIES),
        "databag": {**dataset_digests(train, "train"),
                    **dataset_digests(val, "eval")},
        "train_episodes": episode_digests(train_eps),
        "eval_episodes": episode_digests(eval_eps),
        "batch": batch_digests(batch, meta),
    }
    return table, SimpleNamespace(
        cfg=cfg, pools=pools, raw=raw, train=train, val=val,
        train_eps=train_eps, eval_eps=eval_eps, batch=batch, meta=meta,
        seconds=sec)


# -- the committed reference ---------------------------------------------------


def write_reference(engine, package_root: str, work: str) -> None:
    """Make ``reference/`` from ``engine`` (the JAX package's, on a host
    with OpenCV 5.0)."""
    table, ctx = digest_table(engine, package_root, work)
    shutil.rmtree(REF_DIR, ignore_errors=True)
    shutil.copytree(ctx.raw, SPLIT_DIR)
    with open(TABLE_FP, "w") as f:
        json.dump(table, f, indent=0, sort_keys=True)
        f.write("\n")
    np.savez_compressed(GLYPHS_FP, **glyph_arrays(ctx.pools))
    np.savez_compressed(EPISODES_FP, **warped_arrays(ctx.train_eps))


def load_table() -> Dict[str, Dict[str, str]]:
    with open(TABLE_FP) as f:
        return json.load(f)


def glyph_arrays(pools) -> Dict[str, np.ndarray]:
    return {f"{subset}:{k:03}": glyph for subset, pool in pools.items()
            for k, (_, glyph) in enumerate(pool)}


def warped_arrays(samples: Sequence[Dict]) -> Dict[str, np.ndarray]:
    return {f"{i}:{k}": np.asarray(s[k])
            for i, s in enumerate(samples) for k in WARPED}


def load_arrays(fp: str) -> Dict[str, np.ndarray]:
    with np.load(fp) as z:
        return {k: z[k] for k in z.files}


# -- comparison ----------------------------------------------------------------


def compare(got: Dict[str, str], want: Dict[str, str]) -> List[str]:
    """The keys whose digests differ, or that one side lacks."""
    return sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))


def difference(got: np.ndarray, want: np.ndarray) -> Dict[str, float]:
    """The largest absolute difference, and the shares of elements that
    differ at all and by more than one."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    if not d.size:
        return dict(max_abs=0.0, share=0.0, share_over_1=0.0)
    return dict(max_abs=float(d.max()), share=float((d > 0).mean()),
                share_over_1=float((d > 1).mean()))


def within(got: np.ndarray, want: np.ndarray, tol: Dict[str, float]) -> bool:
    """Same shape and dtype, and the difference inside ``tol``."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    d = difference(got, want)
    return all(d[k] <= tol[k] for k in tol)


def check_stages(engine, package_root: str, work: str) -> Tuple[Dict, Dict]:
    """Hold ``engine`` on this host to the committed reference, stage by
    stage. The glyph bank and the generated split are OpenCV-version
    dependent (see the module's docstring): they are compared with the
    reference and held to their structure. The check generates its own
    split, then builds the datasets and episodes over the committed split.
    → (per stage: ``{"items", "differ" (keys), "held" (bool), "note"}``,
    and ``ctx`` of the run over the generated split, whose datasets the
    caller may train and evaluate on)."""
    want = load_table()
    out = {}

    calls = {k: digest(v) for k, v in cv2_calls().items()}
    bad = compare(calls, want["cv2_calls"])
    out["cv2_calls"] = dict(
        items=len(want["cv2_calls"]), differ=bad,
        held=set(bad) <= set(VERSION_DEPENDENT),
        note="differing calls must be among " + ", ".join(VERSION_DEPENDENT))

    _, ctx = digest_table(engine, package_root, os.path.join(work, "own"))
    ref_glyphs = load_arrays(GLYPHS_FP)
    own = glyph_arrays(ctx.pools)
    bad = compare(glyph_digests(ctx.pools), want["glyph_bank"])
    faults = glyph_structure(engine, ctx.pools, ref_glyphs)
    ious = sorted(ink_iou(own[k], ref_glyphs[k]) for k in bad
                  if k in own and k in ref_glyphs
                  and own[k].shape == ref_glyphs[k].shape)
    out["glyph_bank"] = dict(
        items=len(want["glyph_bank"]), differ=bad, held=not faults,
        note="structure held (glyph_structure), shapes only compared "
             "(putText): " + _faults(faults) + "; " + _stats(
                 [difference(own[k], ref_glyphs[k]) for k in bad])
             + (f"; ink IoU with the reference glyph min {ious[0]:.4g}, "
                f"median {ious[len(ious) // 2]:.4g}, max {ious[-1]:.4g}"
                if ious else ""))
    raw_own = raw_digests(ctx.raw, QUANTITIES)
    bad = compare(raw_own, want["raw_images"])
    faults, n_inst, n_empty = split_structure(engine, ctx.raw, QUANTITIES)
    out["raw_images"] = dict(
        items=len(want["raw_images"]), differ=bad, held=not faults,
        note="this host's split: structure held (split_structure), bytes "
             "only compared (they follow the glyphs): " + _faults(faults)
             + f"; {n_empty} of {n_inst} instances with an empty mask")
    bad = compare(raw_digests(SPLIT_DIR, QUANTITIES), want["raw_images"])
    out["raw_images:committed"] = dict(
        items=len(want["raw_images"]), differ=bad, held=not bad,
        note="the committed split against the table, exact")

    table, ref = digest_table(engine, package_root, os.path.join(work, "ref"),
                              raw=SPLIT_DIR)
    for stage in ("databag", "eval_episodes"):
        bad = compare(table[stage], want[stage])
        out[stage] = dict(items=len(want[stage]), differ=bad, held=not bad,
                          note="on the committed split, exact")

    warped = load_arrays(EPISODES_FP)
    bad = compare(table["train_episodes"], want["train_episodes"])
    stats, ok = [], True
    for k in bad:
        i, field = k.split(":", 1)
        if field not in WARPED:
            ok = False
            continue
        got = np.asarray(ref.train_eps[int(i)][field])
        stats.append(difference(got, warped[k]))
        ok &= within(got, warped[k], TOLERANCE[field])
    # the reference episodes: this host's, with the committed warped fields
    ref_eps = [dict(s, **{f: warped[f"{i}:{f}"] for f in WARPED})
               for i, s in enumerate(ref.train_eps)]
    ok &= not compare(episode_digests(ref_eps), want["train_episodes"])
    out["train_episodes"] = dict(
        items=len(want["train_episodes"]), differ=bad, held=ok,
        note="on the committed split; warped fields within TOLERANCE, the "
             "rest exact; " + _stats(stats))

    rb, rm = engine.collate_episodes(ref_eps, ref.train.mean, ref.train.std,
                                     max_gt=int(ref.cfg.max_gt))
    ok = not compare(batch_digests(rb, rm), want["batch"])
    bad = compare(table["batch"], want["batch"])
    stats = []
    for k in bad:
        kind, field = k.split(":", 1)
        tol = TOLERANCE.get(k)
        if kind != "batch" or tol is None:
            ok = False
            continue
        got, ref_v = getattr(ref.batch, field), getattr(rb, field)
        stats.append(difference(got, ref_v))
        ok &= within(got, ref_v, tol)
    out["batch"] = dict(
        items=len(want["batch"]), differ=bad, held=ok,
        note="the train episodes collated; image and mask fields within "
             "TOLERANCE of the reference episodes' batch, the rest exact; "
             + _stats(stats))
    return out, ctx


def _faults(faults: Sequence[str]) -> str:
    if not faults:
        return "no faults"
    return f"{len(faults)} faults: " + "; ".join(faults[:4])


def _stats(diffs: Sequence[Dict[str, float]]) -> str:
    if not diffs:
        return "no differences"
    return (f"over {len(diffs)} differing items: max |d| "
            f"{max(d['max_abs'] for d in diffs):.6g}, largest share "
            f"differing {max(d['share'] for d in diffs):.6g}, by more than 1 "
            f"{max(d['share_over_1'] for d in diffs):.6g}")
