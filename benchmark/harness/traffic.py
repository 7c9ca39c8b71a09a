"""The one generator of traffic: a mix file's parameters and a seed in, the
run's stream of items out. Every seed gives items of the same sizes and the
same set of arrival gaps; the seed picks the contents (photos, prompts,
noise, batches) and their order.

A mix file (`traffic/<mix>.json`) holds:
  * "draws": the fields that each item draws from the run's seed, in this
    order: [field, "seed"] a seed of 62 bits (the builder makes the item's
    inputs from it), [field, "choice", key] one entry of the mix's list `key`;
  * "arrival": "closed_loop", with "clients" (1 if absent): each client
    sends its next item once its last one has returned; or {"process":
    "open_loop", "rate_per_s": r, "pool": n}: Poisson arrivals at r items
    a second, from one pool of n exponential gaps that depends on the mix
    alone, in an order drawn from the seed, pool after pool; each item then
    carries "arrival_s", the sum of the gaps before it (`core.serve` keeps
    to it);
  * "kind": what the builder makes of an item ("personalized_requests": a
    new subject's photos, a prompt, images to generate; "training_batches":
    a training step's batch);
  * every other key: copied into each item as it is (the lists that a
    "choice" draws from excepted).
A new mix of these kinds, or of these arrivals, is a new data file.
"""

from __future__ import annotations

import numpy as np

from benchmark.harness.weights import seed_for

META = ("kind", "arrival", "clients", "draws")


def items(mix: dict, seed: int):
    """The endless stream of a mix's items for `seed`."""
    draws = mix.get("draws", [])
    for d in draws:
        if d[1] not in ("seed", "choice"):
            raise ValueError(f"unknown draw {d!r}")
    lists = {d[2] for d in draws if d[1] == "choice"}
    const = {k: v for k, v in mix.items() if k not in META and k not in lists}
    gaps = _gaps(mix, seed)
    i, t = 0, 0.0
    while True:
        rng = np.random.default_rng(seed_for(seed, 101, i))
        item = {"index": i, **const}
        for d in draws:
            if d[1] == "seed":
                item[d[0]] = int(rng.integers(0, 1 << 62))
            else:
                item[d[0]] = mix[d[2]][int(rng.integers(len(mix[d[2]])))]
        if gaps is not None:
            item["arrival_s"] = t
            t += next(gaps)
        yield item
        i += 1


def _gaps(mix: dict, seed: int):
    """The open loop's gaps between arrivals, or None for a closed loop."""
    arr = mix.get("arrival", "closed_loop")
    if isinstance(arr, str) or arr.get("process", "closed_loop") == "closed_loop":
        return None
    if arr["process"] != "open_loop":
        raise ValueError(f"unknown arrival process {arr['process']!r}")
    n = int(arr["pool"])
    pool = np.random.default_rng(seed_for(0, 105)).exponential(1.0 / float(arr["rate_per_s"]), n)

    def gen():
        block = 0
        while True:
            yield from pool[np.random.default_rng(seed_for(seed, 106, block)).permutation(n)].tolist()
            block += 1
    return gen()


def training_batch(item: dict) -> dict:
    """A training step's host batch with the keys a trainer reads: 'image'
    (float32 in [-1, 1]), 'image_unnorm' (uint8), 'fg_mask', 'aug_mask'
    (uint8), 'caption', and the rows' face vectors 'faceid' [B, face_dim]."""
    rng = np.random.default_rng(item["batch_seed"])
    b, n = item["batch_size"], item["image_size"]
    img = rng.integers(0, 256, (b, n, n, 3), dtype=np.uint8)
    faceid = rng.standard_normal((b, item["face_dim"]), dtype=np.float32)
    r0, r1, c0, c1 = item["fg_box"]
    fg = np.zeros((b, n, n), np.uint8)
    fg[:, r0:r1, c0:c1] = 1
    aug = np.ones((b, n, n), np.uint8)
    aug[:, :, :item["pad_left"]] = 0
    return {"image": img.astype(np.float32) / np.float32(127.5) - np.float32(1.0), "image_unnorm": img,
            "fg_mask": fg, "aug_mask": aug, "caption": [item["caption"]] * b, "faceid": faceid}


def photos(item: dict) -> list:
    """The request's photos: uint8 RGB, seeded uniform noise."""
    rng = np.random.default_rng(item["photo_seed"])
    h, w = item["photo_size"]
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(item["photos"])]
