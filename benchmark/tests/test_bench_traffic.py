"""The traffic generator and the serving loop: a mix file's draws and
arrivals, the same sizes and gaps for every seed, and `core.serve`'s
clients, arrivals, and least count of items."""

import itertools
import types

import pytest

from benchmark.harness import core, manifest, traffic


def _take(mix, seed, n=12):
    return list(itertools.islice(traffic.items(mix, seed), n))


def test_a_mix_file_draws_its_fields():
    mix = {"kind": "personalized_requests", "draws": [["prompt", "choice", "prompts"], ["noise_seed", "seed"]],
           "prompts": ["a", "b", "c"], "num_steps": 20, "photo_size": [64, 80]}
    items = _take(mix, 2**31 + 3)
    assert [it["index"] for it in items] == list(range(12))
    for it in items:
        assert set(it) == {"index", "prompt", "noise_seed", "num_steps", "photo_size"}
        assert it["prompt"] in mix["prompts"] and 0 <= it["noise_seed"] < 2**62
        assert it["num_steps"] == 20 and it["photo_size"] == [64, 80]
    assert _take(mix, 2**31 + 3) == items
    assert [it["noise_seed"] for it in _take(mix, 2**31 + 4)] != [it["noise_seed"] for it in items]


@pytest.mark.parametrize("name", ["ddim50_x4", "distill_bs8"])
def test_every_seed_gets_the_same_sizes(name):
    mix = manifest.traffic(name)
    seeds = [it for it in mix.get("draws", []) if it[1] == "seed"]
    strip = lambda it: {k: v for k, v in it.items() if k not in {d[0] for d in mix["draws"]}}
    assert seeds
    assert [strip(it) for it in _take(mix, 1)] == [strip(it) for it in _take(mix, 3 * 2**31 + 7)]


def test_open_loop_gaps_are_one_pool_in_another_order():
    mix = {"kind": "training_batches", "arrival": {"process": "open_loop", "rate_per_s": 4.0, "pool": 8},
           "draws": [["batch_seed", "seed"]]}
    a, b = _take(mix, 5, 17), _take(mix, 2**33 + 1, 17)
    gaps = lambda its: [y["arrival_s"] - x["arrival_s"] for x, y in zip(its, its[1:])]
    ga, gb = gaps(a), gaps(b)
    assert a[0]["arrival_s"] == 0.0 and all(g > 0 for g in ga)
    assert sorted(ga[:8]) == pytest.approx(sorted(gb[:8])) and sorted(ga[8:16]) == pytest.approx(sorted(ga[:8]))
    assert ga[:8] != gb[:8]
    assert sum(ga[:8]) / 8 == pytest.approx(0.25, rel=0.6)
    assert core.arrivals(mix) == {"process": "open_loop", "rate_per_s": 4.0, "pool": 8}


class _Cell:
    """A cell whose item takes `service` seconds of host time."""

    def __init__(self, service):
        self.service, self.afters = service, []

    def prepare(self, item):
        return {"item": item}

    def run(self, req):
        import time
        time.sleep(self.service)
        return 1

    def after(self, req):
        self.afters.append(req["item"]["index"])


def _serve(mix, service, seconds, least=0, limit=None):
    import torch
    cell = _Cell(service)
    done, attempted, error = core.serve(cell, traffic.items(mix, 9), core.arrivals(mix), seconds, limit,
                                        torch.device("cpu"), least)
    assert error is None and attempted == len(done) and cell.afters == [r["index"] for r in done]
    return done


def test_closed_loop_clients_queue_behind_each_other():
    one = _serve({"arrival": "closed_loop", "clients": 1}, 0.02, 0.0, least=4)
    assert len(one) == 4
    for r in one:
        assert r["start"] - r["arrival"] < 0.01
    two = _serve({"arrival": "closed_loop", "clients": 2}, 0.02, 0.0, least=6)
    assert two[0]["arrival"] == pytest.approx(two[1]["arrival"], abs=0.005)
    for prev, r in zip(two, two[2:]):
        # a client's next request arrives when its last one has returned, and waits for the other's
        assert r["arrival"] >= prev["end"] and r["start"] - r["arrival"] > 0.01


def test_open_loop_waits_for_each_arrival():
    mix = {"arrival": {"process": "open_loop", "rate_per_s": 20.0, "pool": 4}}
    done = _serve(mix, 0.001, 0.0, least=5)
    want = [it["arrival_s"] for it in _take(mix, 9, 5)]
    t0 = done[0]["arrival"]
    assert [r["arrival"] - t0 for r in done] == pytest.approx(want, abs=1e-9)
    for r in done:
        assert r["start"] >= r["arrival"] - 1e-4


def test_the_window_serves_at_least_the_checked_items_and_at_most_the_limit():
    assert len(_serve({}, 0.0, 0.0, least=3)) == 3
    assert len(_serve({}, 0.001, 10.0, limit=2)) == 2


def test_a_path_off_the_configuration_is_counted():
    for name in ("sd15_adaface", "sd15_adaface_stage1"):
        builder = manifest.config_builder(name)
        cfg = manifest.config(name)
        ucfg = lambda **kw: types.SimpleNamespace(**dict({"quant": None, "fused_conv": False}, **kw))
        assert builder.off_config(cfg, ucfg()) == 0
        assert builder.off_config(cfg, ucfg(quant="int8")) == 1
        assert builder.off_config(cfg, ucfg(quant="int8", fused_conv=True)) == 2
