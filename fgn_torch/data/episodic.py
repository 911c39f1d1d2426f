"""Episodic N-way K-shot few-shot instance-segmentation dataset engine.

Rebuild of the reference's ``BaseFewShotISEG``
(datasets/fewshotiseg/base_fst.py, 1601 LoC) in pure NumPy/cv2, a copy
of the JAX package's ``data/episodic.py``. The engine owns:

  * config-driven init via the typed setattr loop (base_fst.py:172-189 →
    fgn_torch.config.apply_typed_config);
  * base/novel category split (``select_cats``, :267-294);
  * the cached **databag**: per-image parents with per-category instance
    lists, flat instance table, per-category support pools filtered by
    ``ann_min_size_ratio`` (:296-484) — cache filenames follow the
    reference scheme ``{setup}_{ds}_{subset}_{cats}_FilterArea{r}_FT_{mode}[_K{k}].pkl``
    (:250-262);
  * finetune modes (:306-389): **Ignore** drops non-saved categories,
    **Select** restricts images to the greedy FT selection
    (data/fs_selection.py), **Use** turns the selected images into
    support-only banks (``ft_img_sp``) and everything else into queries;
  * parents/children sampling scenarios, ``first_parents__only``
    truncation, ``repeats`` (:438-476);
  * episode construction: query build with FGN category sampling
    (:790-820), aspect-preserving resize, optional augmentation; support
    crops with ``offset_ratio = 1/(2*fill_ratio) - 0.5`` square padding
    (:1000-1041,1103-1159);
  * deterministic replay by stored ids (:1229-1240) — the category-
    shuffle evaluation protocol depends on it;
  * ``merge_ds`` for the finetune stage (:533-603);
  * epoch-seeded ``reshuffle`` with AR-group batching for mixed-aspect
    datasets (:605-732) and real iterator ``state_dict`` (the reference
    stubs it, :1379-1385).

Boxes are YXYX throughout (the XYXY flip happens in data/batching.py).
"""

from __future__ import annotations

import os
import random
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import cv2
import numpy as np

from fgn_torch.config import apply_typed_config
from fgn_torch.data.augment import Augmenter
from fgn_torch.data.fs_selection import select_indices
from fgn_torch.data.synth import get_new_shape
from fgn_torch.utils.io import read_pkl, write_pkl_unsafe


def _resize_mask_stack(masks: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """Resize a (g, h, w) mask stack in one cv2 call (g as channels).
    Float masks (soft quarter-res targets) resize bilinear; binary
    masks resize nearest and stay boolean/uint8."""
    g = masks.shape[0]
    soft = masks.dtype.kind == "f"
    if masks.dtype == bool:
        masks = masks.astype(np.uint8)
    stack = np.ascontiguousarray(np.moveaxis(masks, 0, -1))
    out = cv2.resize(
        stack, (nw, nh),
        interpolation=cv2.INTER_LINEAR if soft else cv2.INTER_NEAREST,
    )
    if g == 1:  # cv2 drops the channel axis
        out = out[..., None]
    return np.moveaxis(out, -1, 0)


class FewShotISEG:
    # ---- typed-config schema: class attributes are the defaults
    # (reference base_fst.py:41-150) --------------------------------------
    n_ways = 3
    k_shots = 1
    ds_base_ = ""
    ds_base__subset = "train"
    ds_novel = ""
    ds_novel_subset = "val"
    sampling_origin_ds = ""
    sampling_origin_ds_subset = "train"
    sampling_cats = "base_"  # base_ | novel | all
    sampling_scenario = "parents"  # parents | children
    repeats = 1
    first_parents__only = 0
    finetune = "Ignore"  # Ignore | Select | Use
    shuffle = False
    qry_cats_choice_random = True
    qry_cats_order_shuffle = False
    augment_qry = False
    augment_spp = False
    spp_random = True
    spp_fill_ratio = 0.8
    ann_min_size_ratio = 0.005
    delete_qry_insts_in_spp_insts_on_train = True
    overfit_sample_mode = False
    batch = 8
    root = ""  # databag / selection cache dir
    inner_root = ""  # raw dataset root
    spp_img_size = 128
    # Pre-built support bank (SURVEY §7 hard part 5, VERDICT r4 item 2):
    # materialize every eligible support instance's pre-augment crop
    # (img / bbox-in-crop / mask) into memmapped .npy files next to the
    # databag, keyed by databag prefix + spp geometry. get_support then
    # costs a page-cache read instead of decode + color-key + crop,
    # first epoch included. Built lazily
    # at init (one sequential pass over the raw images), cached on disk
    # like every other derivation (SURVEY §5.9).
    spp_bank = True
    # LRU capacities (entries): decoded parent images (~0.8 MB each at
    # 512px), pre-augment support crops (~65 KB each at S=128) and
    # reconstructed instance masks (~0.26 MB each at 512px); sized to
    # hold ALL of OMNIISEG (10k images, ~35k instances) so steady-state
    # epochs pay zero decode/keying cost. 0 disables a cache.
    img_cache_entries = 20000
    spp_crop_cache_entries = 80000
    mask_cache_entries = 80000
    # Query-mask resolution divisor. Training configs set 4: mask
    # targets are only ever consumed at H/4 (batching.py), so the whole
    # query-mask pipeline (reconstruct → resize → warp → collate) runs
    # at 1/16 the pixels. Eval datasets keep 1 — FSISEGEval matches
    # against full-resolution gt masks.
    qry_mask_scale = 1
    # bound by subclasses (data/fst_bindings.py)
    inner_ds_cl = None

    def __init__(self, config: Dict):
        apply_typed_config(self, dict(config))
        # Default roots: raw data under data/{ds_name}, databags under
        # data/fst (explicit config keys override — tests use tmp dirs).
        if not self.inner_root and self.inner_ds_cl is not None:
            self.inner_root = os.path.join("data", self.inner_ds_cl.ds_name)
        if not self.root:
            self.root = os.path.join("data", "fst")
        assert self.root, "FewShotISEG needs a cache root"
        assert self.finetune in ("Ignore", "Select", "Use"), self.finetune
        assert self.sampling_cats in ("base_", "novel", "all")
        assert self.sampling_scenario in ("parents", "children")
        os.makedirs(self.root, exist_ok=True)
        # cat -> times the post-exclusion support pool emptied and fell
        # back to the full pool (see get_support)
        self._spp_pool_fallbacks: Dict[int, int] = {}

        self.inner_ds = self.make_inner_ds(
            self.sampling_origin_ds, self.sampling_origin_ds_subset
        )
        self.inner_dss = [self.inner_ds]
        self.mean = self.inner_ds.mean
        self.std = self.inner_ds.std
        self.target_size = self.inner_ds.target_size
        self.max_size = self.inner_ds.max_size

        self.cats_total_amount = self.inner_ds.num_cats
        self.cats_novel = np.asarray(self.select_cats(), np.int64)
        base_mask = np.ones(self.cats_total_amount, bool)
        base_mask[self.cats_novel] = False
        self.cats_base_ = np.nonzero(base_mask)[0]
        self._set_cats_to_save()

        self.augmenter = Augmenter()
        self._overfit_cache = None
        self._group_hw: Dict[int, Tuple[int, int]] = {}
        # Host-side LRU caches (reference keeps decoded-image / crop
        # caches too, base_fst.py:1085-1159). Support-crop construction
        # is ~all image-decode + mask reconstruction — both cacheable;
        # augmentation stays per-use.
        self._img_cache: "OrderedDict" = OrderedDict()
        self._spp_crop_cache: "OrderedDict" = OrderedDict()
        self._mask_cache: "OrderedDict" = OrderedDict()

        self.load_dataset()
        self._spp_bank: Optional[Dict] = None
        self._load_or_build_spp_bank()
        self._build_order()

    # -- subclass hooks ---------------------------------------------------

    def make_inner_ds(self, ds_name: str, subset: str):
        assert self.inner_ds_cl is not None, "bind inner_ds_cl in a subclass"
        return self.inner_ds_cl(imgs_set=subset, root=self.inner_root)

    def select_cats(self) -> Sequence[int]:
        raise NotImplementedError

    # -- category bookkeeping ----------------------------------------------

    def _set_cats_to_save(self):
        if self.sampling_cats == "base_":
            self.cats_to_save = self.cats_base_
        elif self.sampling_cats == "novel":
            self.cats_to_save = self.cats_novel
        else:
            self.cats_to_save = np.arange(self.cats_total_amount)
        bool_mask = np.zeros(self.cats_total_amount, bool)
        bool_mask[self.cats_to_save] = True
        self.cats_to_save_bool = bool_mask

    @property
    def setup_name(self) -> str:
        return f"{self.ds_base_}2{self.ds_novel}"

    @property
    def databag_prefix(self) -> str:
        name = (
            f"{self.setup_name}_{self.sampling_origin_ds}"
            f"_{self.sampling_origin_ds_subset}_{self.sampling_cats}"
            f"_FilterArea{self.ann_min_size_ratio}_FT_{self.finetune}"
        )
        if self.finetune != "Ignore":
            name += f"_K{self.k_shots}"
        return name

    @property
    def databag_fp(self) -> str:
        if getattr(self, "_merged_databag_fp", None):
            return self._merged_databag_fp
        return os.path.join(self.root, self.databag_prefix + ".pkl")

    # -- databag build ------------------------------------------------------

    def _raw_entries(self):
        """[(inner_idx, bboxes (g,4) YXYX, cat_ids (g,), (h, w)), ...]
        annotation-only scan, no pixel decoding."""
        ds = self.inner_ds
        out = []
        for i in range(len(ds)):
            bboxes, cat_ids = ds.ann(i)
            out.append((i, bboxes, cat_ids, ds.img_hw(i)))
        return out

    def _inst_big_enough(self, bbox, hw) -> bool:
        area = max(bbox[2] - bbox[0], 0) * max(bbox[3] - bbox[1], 0)
        return area / float(hw[0] * hw[1]) >= self.ann_min_size_ratio

    def _ft_selection(self, entries) -> List[int]:
        """Greedy FT image selection over the raw entries (inner idxs)."""
        C = self.cats_total_amount
        counts = np.zeros((len(entries), C), np.int64)
        for row, (_, bboxes, cat_ids, hw) in enumerate(entries):
            for c in cat_ids:
                counts[row, int(c)] += 1
        budget = (
            3 * self.k_shots if self.sampling_cats == "base_"
            else self.k_shots + 1
        )
        cache_fp = os.path.join(
            self.root, self.databag_prefix + "_FINETUNE_REAL_INDICES.json"
        )
        rows = select_indices(
            counts, self.cats_to_save_bool, budget, cache_fp=cache_fp
        )
        return [entries[r][0] for r in rows]

    def load_dataset(self):
        if os.path.isfile(self.databag_fp):
            bag = read_pkl(self.databag_fp)
            self.qrys_parents_ = bag["qrys_parents_"]
            self.qrys_children = bag["qrys_children"]
            self.insts = bag["insts"]
            self.cats_insts_list = bag["cats_insts_list"]
            return

        entries = self._raw_entries()
        selected: Optional[set] = None
        if self.finetune in ("Select", "Use"):
            selected = set(self._ft_selection(entries))

        parents: List[Dict] = []
        insts: List[Dict] = []
        pools: List[List[int]] = [[] for _ in range(self.cats_total_amount)]

        for inner_idx, bboxes, cat_ids, hw in entries:
            is_ft_img = selected is not None and inner_idx in selected
            if self.finetune == "Select" and not is_ft_img:
                continue  # Select: only the FT subset exists at all
            if self.finetune == "Use":
                # disallowed-cat images were never candidates; they are
                # not usable as queries either (support pools must stay
                # clean and queries must be pure saved-cat images)
                if (~self.cats_to_save_bool[cat_ids]).any():
                    continue

            if self.finetune == "Use" and is_ft_img:
                # FT-selected images: support bank only, never a query
                for slot, (bbox, cat) in enumerate(zip(bboxes, cat_ids)):
                    cat = int(cat)
                    if not self.cats_to_save_bool[cat]:
                        continue
                    inst_id = len(insts)
                    insts.append({
                        "parent_idx": -1, "ds_id": 0,
                        "inner_idx": inner_idx, "slot": slot,
                        "bbox": np.asarray(bbox, np.float32),
                        "cat_id": cat,
                        "ft_img_sp": self.inner_ds.img_fp(inner_idx),
                    })
                    if self._inst_big_enough(bbox, hw):
                        pools[cat].append(inst_id)
                continue

            parent_idx = len(parents)
            cats_dict: Dict[int, List[int]] = {}
            kept_any = False
            for slot, (bbox, cat) in enumerate(zip(bboxes, cat_ids)):
                cat = int(cat)
                if not self.cats_to_save_bool[cat]:
                    continue  # Ignore/Select: non-saved cats dropped
                inst_id = len(insts)
                insts.append({
                    "parent_idx": parent_idx, "ds_id": 0,
                    "inner_idx": inner_idx, "slot": slot,
                    "bbox": np.asarray(bbox, np.float32),
                    "cat_id": cat,
                })
                cats_dict.setdefault(cat, []).append(inst_id)
                kept_any = True
                if self.finetune != "Use" and self._inst_big_enough(bbox, hw):
                    pools[cat].append(inst_id)
            if not kept_any:
                continue  # parent with no saved-cat instance: skip
            parents.append({
                "inner_idx": inner_idx, "ds_id": 0, "hw": tuple(hw),
                "cats_dict": cats_dict,
            })

        # children: one (parent, category) pair per on-image category
        children = [
            (p_idx, cat)
            for p_idx, p in enumerate(parents)
            for cat in sorted(p["cats_dict"])
        ]
        self.qrys_parents_ = parents
        self.qrys_children = np.asarray(children, np.int64).reshape(-1, 2)
        self.insts = insts
        self.cats_insts_list = pools
        write_pkl_unsafe(self.databag_fp, {
            "qrys_parents_": parents,
            "qrys_children": self.qrys_children,
            "insts": insts,
            "cats_insts_list": pools,
        })

    # -- pre-built support bank ----------------------------------------------

    @property
    def _spp_bank_prefix(self) -> str:
        base = self.databag_fp
        if base.endswith(".pkl"):
            base = base[:-4]
        return f"{base}_SPPBANK_S{self.spp_img_size}_F{self.spp_fill_ratio}"

    def _load_or_build_spp_bank(self):
        """Build (once, disk-cached) and memmap the support bank: for
        every instance in any support pool, the pre-augment output of
        ``_make_support_crop`` — crop (S,S,3 u8), bbox-in-crop (4 f32),
        mask (S,S u8). Reference anchor: the per-use crop math this
        replaces is base_fst.py:1085-1159."""
        self._spp_bank = None
        if not self.spp_bank:
            return
        eligible = sorted({i for pool in self.cats_insts_list for i in pool})
        if not eligible:
            return
        prefix = self._spp_bank_prefix
        fps = {k: f"{prefix}_{k}.npy" for k in ("imgs", "masks", "bboxes", "ids")}

        ids = np.asarray(eligible, np.int64)
        fresh = all(os.path.isfile(fp) for fp in fps.values())
        if fresh:
            on_disk = np.load(fps["ids"])
            fresh = on_disk.shape == ids.shape and (on_disk == ids).all()
        if not fresh:
            t0 = time.perf_counter()
            S = self.spp_img_size
            imgs = np.lib.format.open_memmap(
                fps["imgs"] + ".tmp", mode="w+",
                dtype=np.uint8, shape=(len(ids), S, S, 3),
            )
            masks = np.lib.format.open_memmap(
                fps["masks"] + ".tmp", mode="w+",
                dtype=np.uint8, shape=(len(ids), S, S),
            )
            bboxes = np.zeros((len(ids), 4), np.float32)
            for row, inst_id in enumerate(ids):
                crop, bbox, mcrop = self._make_support_crop(
                    self.insts[int(inst_id)]
                )
                imgs[row] = crop
                masks[row] = mcrop
                bboxes[row] = bbox
            imgs.flush()
            masks.flush()
            del imgs, masks
            os.replace(fps["imgs"] + ".tmp", fps["imgs"])
            os.replace(fps["masks"] + ".tmp", fps["masks"])
            np.save(fps["bboxes"], bboxes)
            np.save(fps["ids"], ids)
            # the build walked every parent image; drop the transient
            # decode/mask LRU state it left behind
            self._img_cache.clear()
            self._mask_cache.clear()
            print(
                f"support bank built: {len(ids)} insts "
                f"-> {os.path.basename(prefix)} "
                f"({time.perf_counter() - t0:.1f}s)"
            )
        else:
            # warm the page cache sequentially (same trick as the
            # raw-image warmup)
            for key in ("imgs", "masks"):
                with open(fps[key], "rb") as f:
                    while f.read(1 << 25):
                        pass
        self._spp_bank = {
            "imgs": np.load(fps["imgs"], mmap_mode="r"),
            "masks": np.load(fps["masks"], mmap_mode="r"),
            "bboxes": np.load(fps["bboxes"]),
            "row": {int(v): r for r, v in enumerate(ids)},
        }

    # np.memmap pickles BY VALUE (as a plain ndarray) — a dataset sent
    # to loader worker processes would materialize the whole bank
    # (hundreds of MB at OMNI scale) per worker. Ship the file paths
    # instead and reopen the memmaps on unpickle.
    def __getstate__(self):
        state = self.__dict__.copy()
        bank = state.get("_spp_bank")
        if bank is not None and not isinstance(bank.get("imgs"), str):
            prefix = self._spp_bank_prefix
            bank = dict(bank)
            bank["imgs"] = f"{prefix}_imgs.npy"
            bank["masks"] = f"{prefix}_masks.npy"
            state["_spp_bank"] = bank
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        bank = getattr(self, "_spp_bank", None)
        if bank is not None and isinstance(bank.get("imgs"), str):
            bank["imgs"] = np.load(bank["imgs"], mmap_mode="r")
            bank["masks"] = np.load(bank["masks"], mmap_mode="r")

    # -- order / shuffle ------------------------------------------------------

    def _build_order(self):
        if self.sampling_scenario == "parents":
            n = len(self.qrys_parents_)
        else:
            n = len(self.qrys_children)
        if self.first_parents__only:
            n = min(n, self.first_parents__only)
        self.order_initial = np.tile(np.arange(n), self.repeats)
        self.order = self.order_initial.copy()
        self._children_of_parent = [[] for _ in self.qrys_parents_]
        for child_idx, (p_idx, _cat) in enumerate(self.qrys_children):
            self._children_of_parent[int(p_idx)].append(child_idx)

    def reshuffle(self, e: Optional[int] = None):
        """Epoch-seeded reshuffle (reference base_fst.py:618-623:
        ``random.Random((2**e) % 1000)``) + AR-group batching for
        mixed-aspect datasets (:605-732)."""
        self.order = self.order_initial.copy()
        self._group_hw = {}
        rnd = (
            random.Random((2 ** int(e)) % 1000)
            if e is not None else random.Random()
        )
        if self.shuffle:
            order = self.order.tolist()
            rnd.shuffle(order)
            self.order = np.asarray(order, np.int64)
        self._apply_ar_grouping(rnd)

    def _entry_parent(self, entry: int) -> int:
        if self.sampling_scenario == "parents":
            return int(entry)
        return int(self.qrys_children[entry][0])

    def _parent_resize_policy(self, parent: Dict) -> Tuple[int, int]:
        """(target_size, max_size) for a parent by its ORIGIN dataset.

        Merged FT datasets (COCO base + VOC novel) keep per-dataset
        resize policies like the reference's concatenated per-dataset
        pipelines (coco_ds.py 800/1333 vs voc_ds.py 512/512) — without
        this, VOC-origin FT queries would be upscaled to the COCO
        canvas, a silent 800-vs-512 protocol deviation (and ~3x wasted
        pixels) relative to the VOC-only FT=Use eval."""
        ds = self.inner_dss[int(parent.get("ds_id", 0))]
        return int(ds.target_size), int(ds.max_size)

    def _apply_ar_grouping(self, rnd: Optional[random.Random] = None):
        """Group order entries by (origin ds, rounded aspect ratio) so
        each batch has one static shape; per-entry target HW recorded in
        _group_hw.

        Square-image datasets (MNISTISEG/OMNIISEG) collapse to a single
        group and this is a no-op."""
        ars = {}
        for pos, entry in enumerate(self.order):
            parent = self.qrys_parents_[self._entry_parent(int(entry))]
            h, w = parent["hw"]
            key = (int(parent.get("ds_id", 0)), round(float(h) / float(w), 1))
            ars.setdefault(key, []).append(pos)
        if len(ars) <= 1:
            return
        new_order = []
        group_hw = {}
        bs = max(int(self.batch), 1)
        for ar in sorted(ars):
            positions = ars[ar]
            # pad the group to a batch multiple by cycling its own
            # entries (rare-AR groups can be smaller than the batch)
            n_orig = len(positions)
            while len(positions) % bs:
                positions.append(positions[len(positions) % n_orig])
            # group target: the max resized hw over the group, stride-16
            hws = []
            for pos in positions:
                parent = self.qrys_parents_[
                    self._entry_parent(int(self.order[pos]))
                ]
                h, w = parent["hw"]
                tgt_size, max_size = self._parent_resize_policy(parent)
                hws.append(get_new_shape(h, w, tgt_size, max_size))
            hws = np.asarray(hws)
            tgt = hws.max(axis=0)
            tgt = tuple(int(-16 * (-v // 16)) for v in tgt)  # snap up to /16
            for pos in positions:
                group_hw[len(new_order)] = tgt
                new_order.append(int(self.order[pos]))
        # chunk-shuffle whole batches so groups interleave (epoch-seeded
        # rnd: the order must replay identically on resume)
        chunks = [
            list(range(i, i + bs)) for i in range(0, len(new_order), bs)
        ]
        (rnd or random).shuffle(chunks)
        order, ghw = [], {}
        for chunk in chunks:
            for p in chunk:
                ghw[len(order)] = group_hw[p]
                order.append(new_order[p])
        self.order = np.asarray(order, np.int64)
        self._group_hw = ghw

    def state_dict(self) -> Dict:
        return {
            "order": np.asarray(self.order).copy(),
            "group_hw": dict(self._group_hw),
        }

    def load_state_dict(self, state: Dict):
        self.order = np.asarray(state["order"]).copy()
        # keys may arrive as str (JSON sidecar / legacy orbax dicts)
        self._group_hw = {
            int(k): (int(v[0]), int(v[1]))
            for k, v in dict(state.get("group_hw", {})).items()
        }

    def __len__(self):
        return len(self.order)

    # -- image access (merged datasets may have two inner dss) ---------------

    def _read_parent_img(self, ds_id: int, inner_idx: int) -> np.ndarray:
        """Decoded-image LRU. Callers never mutate the returned array in
        place (resize/warp/collate all copy)."""
        key = (ds_id, inner_idx)
        cache = self._img_cache
        if key in cache:
            cache.move_to_end(key)
            return cache[key]
        img = self.inner_dss[ds_id].read_img(inner_idx)
        if self.img_cache_entries:
            cache[key] = img
            if len(cache) > self.img_cache_entries:
                cache.popitem(last=False)
        return img

    def _get_mask(self, inst: Dict, scale: int = 1) -> np.ndarray:
        """Instance-mask LRU: color-key mask reconstruction would be
        re-done for every query instance every epoch — cache by (ds,
        image, slot, scale). ``scale`` > 1 caches the
        block-mean-downsampled float32 mask (quarter-res training
        targets). Callers never mutate the result (resize/warp/collate
        all copy)."""
        key = (inst["ds_id"], inst["inner_idx"], inst["slot"], scale)
        cache = self._mask_cache
        hit = cache.get(key)
        if hit is not None:
            cache.move_to_end(key)
            return hit
        mask = self.inner_dss[inst["ds_id"]].get_isegmap(
            inst["inner_idx"], inst["slot"]
        )
        if scale != 1:
            h, w = mask.shape
            mh, mw = h // scale, w // scale
            mask = (
                mask[: mh * scale, : mw * scale]
                .reshape(mh, scale, mw, scale)
                .astype(np.float32)
                .mean(axis=(1, 3))
            )
        if self.mask_cache_entries:
            cache[key] = mask
            if len(cache) > self.mask_cache_entries:
                cache.popitem(last=False)
        return mask

    # -- episode construction --------------------------------------------------

    def _sample_episode_cats(self, main_cat: int) -> List[int]:
        allowed = [
            c for c in self.cats_to_save.tolist()
            if len(self.cats_insts_list[c]) and c != main_cat
        ]
        if self.qry_cats_choice_random:
            others = random.sample(allowed, min(self.n_ways - 1, len(allowed)))
        else:
            others = allowed[: self.n_ways - 1]
        cats = [main_cat] + others
        assert len(cats) == self.n_ways, (
            f"not enough categories with support instances: {cats}"
        )
        if self.qry_cats_order_shuffle:
            random.shuffle(cats)
        return cats

    def get_query(self, parent_idx: int, cats: List[int],
                  pad_hw: Optional[Tuple[int, int]] = None):
        parent = self.qrys_parents_[parent_idx]
        img = self._read_parent_img(parent["ds_id"], parent["inner_idx"])
        h, w = img.shape[:2]

        inst_ids: List[int] = []
        for c in cats:
            inst_ids.extend(parent["cats_dict"].get(c, []))
        boxes = np.asarray(
            [self.insts[i]["bbox"] for i in inst_ids], np.float32
        ).reshape(-1, 4)
        cat_ids_real = np.asarray(
            [self.insts[i]["cat_id"] for i in inst_ids], np.int64
        )
        ms = self.qry_mask_scale
        masks = (
            np.stack([self._get_mask(self.insts[i], ms) for i in inst_ids])
            if inst_ids
            else np.zeros((0, h // ms, w // ms),
                          np.float32 if ms != 1 else np.uint8)
        )

        if pad_hw is not None:
            new_h, new_w = pad_hw
        else:
            tgt_size, max_size = self._parent_resize_policy(parent)
            new_h, new_w = get_new_shape(h, w, tgt_size, max_size)
        if (new_h, new_w) != (h, w):
            img = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
            sy, sx = new_h / h, new_w / w
            boxes = boxes * np.array([sy, sx, sy, sx], np.float32)
            if len(masks):
                masks = _resize_mask_stack(masks, new_h // ms, new_w // ms)

        if self.augment_qry and len(boxes):
            img, boxes, masks = self.augmenter(img, boxes, masks, mask_scale=ms)
        return img, boxes, cat_ids_real, masks, inst_ids

    # -- support crops (reference get_crop, base_fst.py:1000-1041) ----------

    @property
    def offset_ratio(self) -> float:
        return 1.0 / (2.0 * self.spp_fill_ratio) - 0.5

    def _crop_support(self, inst: Dict, _inst_id: Optional[int] = None):
        """Square crop around the instance box with offset_ratio padding
        (reflect-padded at image borders), resized to spp_img_size.

        Returns (img (S,S,3), bbox YXYX in crop coords, mask (S,S)).
        The pre-augment crop comes from the memmapped support bank when
        built (page-cache read), else is LRU-cached per instance id
        (decode + mask reconstruction dominate episode construction);
        only the random augmentation runs per use."""
        if self._spp_bank is not None and _inst_id is not None:
            row = self._spp_bank["row"].get(int(_inst_id))
            if row is not None:
                b = self._spp_bank
                return self._augment_spp_crop(
                    np.asarray(b["imgs"][row]),
                    b["bboxes"][row].copy(),
                    np.asarray(b["masks"][row]),
                )
        if _inst_id is not None and self.spp_crop_cache_entries:
            cache = self._spp_crop_cache
            hit = cache.get(_inst_id)
            if hit is not None:
                cache.move_to_end(_inst_id)
                return self._augment_spp_crop(*hit)
            crop, bbox, mcrop = self._make_support_crop(inst)
            cache[_inst_id] = (crop, bbox, mcrop)
            if len(cache) > self.spp_crop_cache_entries:
                cache.popitem(last=False)
            return self._augment_spp_crop(crop, bbox, mcrop)
        return self._augment_spp_crop(*self._make_support_crop(inst))

    def _augment_spp_crop(self, crop, bbox, mcrop):
        if not self.augment_spp:
            return crop, bbox, mcrop
        crop_a, bboxes_a, masks_a = self.augmenter(
            crop, bbox[None], mcrop[None]
        )
        return crop_a, bboxes_a[0], np.asarray(masks_a[0], mcrop.dtype)

    def _make_support_crop(self, inst: Dict):
        img = self._read_parent_img(inst["ds_id"], inst["inner_idx"])
        mask = self._get_mask(inst)
        h, w = img.shape[:2]
        y1, x1, y2, x2 = inst["bbox"]
        bh, bw = y2 - y1, x2 - x1
        off = self.offset_ratio
        cy1, cy2 = y1 - bh * off, y2 + bh * off
        cx1, cx2 = x1 - bw * off, x2 + bw * off
        # square: extend the shorter side symmetrically
        side = max(cy2 - cy1, cx2 - cx1)
        yc, xc = (cy1 + cy2) / 2, (cx1 + cx2) / 2
        cy1, cy2 = yc - side / 2, yc + side / 2
        cx1, cx2 = xc - side / 2, xc + side / 2
        iy1, ix1 = int(np.floor(cy1)), int(np.floor(cx1))
        iy2, ix2 = int(np.ceil(cy2)), int(np.ceil(cx2))

        pad_t, pad_l = max(-iy1, 0), max(-ix1, 0)
        pad_b, pad_r = max(iy2 - h, 0), max(ix2 - w, 0)
        crop = img[max(iy1, 0): iy2, max(ix1, 0): ix2]
        mcrop = mask[max(iy1, 0): iy2, max(ix1, 0): ix2]
        if pad_t or pad_b or pad_l or pad_r:
            crop = cv2.copyMakeBorder(
                crop, pad_t, pad_b, pad_l, pad_r, cv2.BORDER_REFLECT_101
            )
            mcrop = cv2.copyMakeBorder(
                mcrop, pad_t, pad_b, pad_l, pad_r, cv2.BORDER_CONSTANT, value=0
            )
        S = self.spp_img_size
        ch, cw = crop.shape[:2]
        crop = cv2.resize(crop, (S, S), interpolation=cv2.INTER_LINEAR)
        mcrop = cv2.resize(mcrop, (S, S), interpolation=cv2.INTER_NEAREST)
        sy, sx = S / ch, S / cw
        bbox = np.array(
            [(y1 - iy1) * sy, (x1 - ix1) * sx, (y2 - iy1) * sy, (x2 - ix1) * sx],
            np.float32,
        )
        return crop, bbox, mcrop

    def get_support(self, cats: List[int], qry_inst_ids: Sequence[int],
                    _spp_insts_ids=None):
        S = self.spp_img_size
        N, K = self.n_ways, self.k_shots
        imgs = np.zeros((N * K, S, S, 3), np.uint8)
        bboxes = np.zeros((N * K, 4), np.float32)
        masks = np.zeros((N * K, S, S), np.float32)
        ids = np.zeros(N * K, np.int64)
        excluded = set(qry_inst_ids) if (
            self.delete_qry_insts_in_spp_insts_on_train
            or self.finetune == "Use"
        ) else set()
        for n, c in enumerate(cats):
            if _spp_insts_ids is not None:
                picks = [int(v) for v in _spp_insts_ids[n * K: (n + 1) * K]]
            else:
                pool = [
                    i for i in self.cats_insts_list[c] if i not in excluded
                ]
                if not pool:
                    # Degenerate few-shot case: every instance of cat c
                    # is in the query image — e.g. a K=1 novel cat whose
                    # greedy FT selection could only reach one instance
                    # (candidate images must contain ONLY allowed cats,
                    # which the deformed-glyph val split makes scarce).
                    # The reference raises NotImplementedError here
                    # (base_fst.py:1067-1075); reusing the full pool
                    # (support == query instance) is the only defined
                    # support and keeps the FT pipeline runnable.
                    pool = list(self.cats_insts_list[c])
                    self._spp_pool_fallbacks[c] = (
                        self._spp_pool_fallbacks.get(c, 0) + 1
                    )
                assert pool, f"no support instances for cat {c}"
                if self.spp_random:
                    picks = [
                        random.choice(pool) for _ in range(K)
                    ] if len(pool) < K else random.sample(pool, K)
                else:
                    picks = [pool[k % len(pool)] for k in range(K)]
            for k, inst_id in enumerate(picks):
                img, bbox, mask = self._crop_support(
                    self.insts[inst_id], _inst_id=int(inst_id)
                )
                slot = n * K + k
                imgs[slot] = img
                bboxes[slot] = bbox
                masks[slot] = mask
                ids[slot] = inst_id
        return imgs, bboxes, masks, ids

    def __getitem__(self, idx: int, _qry_child_idx: Optional[int] = None,
                    _cats_ids_to_sample_real=None, _spp_insts_ids=None):
        if self.overfit_sample_mode and self._overfit_cache is not None:
            return self._overfit_cache

        entry = int(self.order[idx % max(len(self.order), 1)])
        if _qry_child_idx is not None:
            child_idx = int(_qry_child_idx)
        elif self.sampling_scenario == "parents":
            child_idx = random.choice(self._children_of_parent[entry])
        else:
            child_idx = entry
        parent_idx, main_cat = (int(v) for v in self.qrys_children[child_idx])

        if _cats_ids_to_sample_real is not None:
            cats = [int(c) for c in _cats_ids_to_sample_real]
            assert cats[0] == main_cat or main_cat in cats
        else:
            cats = self._sample_episode_cats(main_cat)

        pad_hw = self._group_hw.get(idx)
        img, boxes, cat_ids_real, masks, qry_inst_ids = self.get_query(
            parent_idx, cats, pad_hw
        )
        spp_imgs, spp_bboxes, spp_masks, spp_ids = self.get_support(
            cats, qry_inst_ids, _spp_insts_ids
        )

        mapping = {c: pos for pos, c in enumerate(cats)}
        qry_cat_ids = np.asarray(
            [mapping[int(c)] for c in cat_ids_real], np.int64
        )
        sample = {
            "idx": idx,
            "qry_child_idx": child_idx,
            "qry_img": img,
            "qry_bboxes": boxes,
            "qry_cat_ids": qry_cat_ids,
            "qry_cat_ids_real": cat_ids_real,
            "qry_isegmaps": masks,
            "spp_imgs": spp_imgs,
            "spp_bboxes": spp_bboxes,
            "spp_isegmaps": spp_masks,
            "cats_ids_to_sample_real": np.asarray(cats, np.int64),
            "spp_insts_ids": spp_ids,
            "img_shape": np.asarray([*img.shape[:2], 3], np.int64),
        }
        if self.overfit_sample_mode:
            self._overfit_cache = sample
        return sample

    # -- finetune merge (reference base_fst.py:533-603) ----------------------

    def merge_ds(self, other: "FewShotISEG"):
        assert self.finetune == "Select" and other.finetune == "Select", (
            "merge_ds merges two FT=Select datasets"
        )
        self.inner_dss = [self.inner_ds, other.inner_ds]
        p_off = len(self.qrys_parents_)
        i_off = len(self.insts)

        for p in other.qrys_parents_:
            q = dict(p)
            q["ds_id"] = 1
            q["cats_dict"] = {
                c: [i + i_off for i in ids]
                for c, ids in p["cats_dict"].items()
            }
            self.qrys_parents_.append(q)
        for inst in other.insts:
            j = dict(inst)
            j["ds_id"] = 1
            if j.get("parent_idx", -1) >= 0:
                j["parent_idx"] = j["parent_idx"] + p_off
            self.insts.append(j)
        for c in range(self.cats_total_amount):
            self.cats_insts_list[c] = (
                list(self.cats_insts_list[c])
                + [i + i_off for i in other.cats_insts_list[c]]
            )

        self.sampling_cats = "all"
        self.finetune = "Ignore"
        self._set_cats_to_save()
        children = [
            (p_idx, cat)
            for p_idx, p in enumerate(self.qrys_parents_)
            for cat in sorted(p["cats_dict"])
        ]
        self.qrys_children = np.asarray(children, np.int64).reshape(-1, 2)
        self._build_order()
        merged_fp = os.path.join(
            self.root,
            f"{self.databag_prefix}_MERGED_{other.sampling_origin_ds}"
            f"_{other.sampling_origin_ds_subset}.pkl",
        )
        self._merged_databag_fp = merged_fp
        write_pkl_unsafe(merged_fp, {
            "qrys_parents_": self.qrys_parents_,
            "qrys_children": self.qrys_children,
            "insts": self.insts,
            "cats_insts_list": self.cats_insts_list,
        })
        # inst ids were re-based by the merge: the pre-merge banks no
        # longer apply; build/load the merged bag's own bank
        self._load_or_build_spp_bank()
        return self

    @property
    def merged(self) -> bool:
        return len(self.inner_dss) > 1

    # -- evaluation / viz ------------------------------------------------------

    def evaluate(self, results_pkl_dir_fp: str) -> Dict[str, float]:
        """FSISEGEval over chunked result pkls (reference
        base_fst.py:1516-1601)."""
        from fgn_torch.data.fsisegeval import FSISEGEval

        out = {}
        for iou_type in ("bbox", "segm"):
            ev = FSISEGEval(
                results_pkl_dir_fp=results_pkl_dir_fp,
                n_ways=self.n_ways, iou_type=iou_type,
            )
            m = ev.run()
            out[f"{iou_type}_mAP"] = m["mAP"]
            out[f"{iou_type}_mAR"] = m["mAR"]
        return out

    def visualize_result(self, res: Dict, out_dir: str, name: str):
        """GT (left) vs detections (right) render of one result dict."""
        from fgn_torch.data import rle as RLE

        os.makedirs(out_dir, exist_ok=True)
        h, w = (int(v) for v in res["qry_img_shape"][:2])
        gt = np.full((h, w, 3), 255, np.uint8)
        dt = np.full((h, w, 3), 255, np.uint8)
        palette = [(220, 60, 60), (60, 160, 60), (60, 60, 220),
                   (200, 160, 40), (150, 60, 180)]

        def draw(canvas, boxes, cats, rles, scores=None):
            for j, (b, c) in enumerate(zip(boxes, cats)):
                color = palette[int(c) % len(palette)]
                if rles is not None and j < len(rles):
                    m = RLE.decode(rles[j]).astype(bool)
                    canvas[m] = (
                        0.5 * canvas[m] + 0.5 * np.array(color)
                    ).astype(np.uint8)
                y1, x1, y2, x2 = (int(v) for v in b)
                cv2.rectangle(canvas, (x1, y1), (x2, y2), color, 1)
                label = str(int(c))
                if scores is not None:
                    label += f" {scores[j]:.2f}"
                cv2.putText(canvas, label, (x1, max(y1 - 2, 8)),
                            cv2.FONT_HERSHEY_PLAIN, 0.8, color, 1)

        draw(gt, res["qry_bboxes"], res["qry_cat_ids"],
             res.get("qry_isegmaps_rle"))
        draw(dt, res["dt_bboxes"], res["dt_cat_ids"],
             res.get("dt_isegmaps_rle"), res.get("dt_scores"))
        canvas = np.concatenate([gt, np.full((h, 4, 3), 0, np.uint8), dt], 1)
        cv2.imwrite(os.path.join(out_dir, name), canvas[..., ::-1])

    def visualize(self, out_dir: str, n: int = 5, seed: int = 8):
        """Episode contact sheets: query + gt | support crops
        (reference visualize_item_pro, base_fst.py:1283-1377)."""
        os.makedirs(out_dir, exist_ok=True)
        rnd = random.Random(seed)
        for k in range(min(n, len(self))):
            idx = rnd.randrange(len(self))
            s = self[idx]
            img = s["qry_img"].copy()
            for b, c in zip(s["qry_bboxes"].astype(int), s["qry_cat_ids"]):
                cv2.rectangle(img, (b[1], b[0]), (b[3], b[2]), (0, 0, 0), 2)
                cv2.putText(img, str(int(c)), (b[1], max(b[0] - 3, 10)),
                            cv2.FONT_HERSHEY_PLAIN, 1.2, (0, 0, 0), 2)
            S = self.spp_img_size
            strip_h = img.shape[0]
            cols = []
            for i, (crop, bb) in enumerate(zip(s["spp_imgs"], s["spp_bboxes"])):
                tile = crop.copy()
                b = bb.astype(int)
                cv2.rectangle(tile, (b[1], b[0]), (b[3], b[2]), (255, 0, 0), 1)
                cols.append(tile)
            ncol = max(1, strip_h // S)
            rows = []
            for i in range(0, len(cols), ncol):
                col = np.concatenate(cols[i: i + ncol], axis=0)
                pad = strip_h - col.shape[0]
                if pad > 0:
                    col = np.pad(col, ((0, pad), (0, 0), (0, 0)),
                                 constant_values=255)
                rows.append(col[:strip_h])
            strip = np.concatenate(rows, axis=1) if rows else np.zeros(
                (strip_h, S, 3), np.uint8
            )
            sheet = np.concatenate([img, strip], axis=1)
            cv2.imwrite(
                os.path.join(out_dir, f"Image {k:04}.png"), sheet[..., ::-1]
            )
