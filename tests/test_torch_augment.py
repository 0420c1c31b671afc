"""The port's point-cloud transforms and its TensorBoard writer.

Deterministic transforms are held to the JAX package's on the same numpy
inputs: ``normalize_unit_sphere`` to 2 f32 ulps of the unit sphere (atol
2.4e-7: the centroid's f32 sum runs in another order than XLA's, which moves
the last bit), ``farthest_point_sample`` to the same indices when it starts
from the JAX function's own first index.  The random transforms draw other
numbers than ``jax.random``, so they are held to their invariants.  The
``SummaryWriter`` is checked with tensorboard's own reader, and without the
tensorboard package (blocked here) it writes nothing while a
``--tensorboard`` run still trains.
"""

import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointwise_torch.data import augment as ta
from pointwise_torch.train.cli import main as train
from pointwise_torch.train.trainer import SummaryWriter, log_metrics
from pointwise_tpu.data import augment as ja


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the CPU paths run many small ops; with the test workers sharing the
    # cores, more intra-op threads only add contention
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clouds(seed=0, b=3, n=400):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-3, 5, (b, n, 3)).astype(np.float32),
            (rng.rand(b, n) > 0.3).astype(np.float32))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_normalize_unit_sphere_matches_jax(batched, masked):
    p, m = _clouds()
    if not batched:
        p, m = p[0], m[0]
    m = m if masked else None
    want = np.asarray(ja.normalize_unit_sphere(
        jnp.asarray(p), None if m is None else jnp.asarray(m)))
    got = ta.normalize_unit_sphere(
        torch.from_numpy(p), None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.4e-7)
    norms = got.norm(dim=-1).amax(dim=-1)
    np.testing.assert_allclose(norms.numpy(), 1.0, rtol=1e-6)
    if masked:
        assert torch.all(got[torch.from_numpy(m) == 0] == 0)


@pytest.mark.parametrize("batched", [False, True])
def test_farthest_point_sample_matches_jax_from_its_start(batched):
    p, _ = _clouds(1)
    key = jax.random.PRNGKey(7)
    n = 64
    if batched:
        keys = jax.random.split(key, p.shape[0])
        start = torch.tensor([int(jax.random.randint(k, (), 0, p.shape[1]))
                              for k in keys])
        want = np.asarray(ja.farthest_point_sample(key, jnp.asarray(p), n))
    else:
        p = p[0]
        start = int(jax.random.randint(key, (), 0, p.shape[0]))
        want = np.asarray(ja.farthest_point_sample(key, jnp.asarray(p), n))
    idx = ta.farthest_point_indices(torch.from_numpy(p), n, start)
    got = np.take_along_axis(p, idx.numpy()[..., None], axis=-2)
    np.testing.assert_array_equal(got, want)


def test_farthest_point_sample_draws_distinct_points_with_extras():
    p, _ = _clouds(2)
    labels = np.arange(p.shape[0] * p.shape[1]).reshape(p.shape[:2])
    pts, lab = ta.farthest_point_sample(torch.from_numpy(p), _gen(), 50,
                                        torch.from_numpy(labels))
    assert pts.shape == (3, 50, 3) and lab.shape == (3, 50)
    for b in range(3):
        assert len(set(lab[b].tolist())) == 50          # no point twice
        np.testing.assert_array_equal(
            pts[b].numpy(), p[b][lab[b].numpy() - b * p.shape[1]])
    again = ta.farthest_point_sample(torch.from_numpy(p), _gen(), 50)
    assert torch.equal(again, pts)                      # the generator replays


@pytest.mark.parametrize("rotate, axis", [(ta.rotate_z, 2), (ta.rotate_y, 1)])
def test_rotations_keep_their_axis_and_norms(rotate, axis):
    p = torch.from_numpy(_clouds()[0])
    r = rotate(p, _gen())
    torch.testing.assert_close(r[..., axis], p[..., axis], rtol=0, atol=1e-6)
    torch.testing.assert_close(r.norm(dim=-1), p.norm(dim=-1), rtol=1e-5,
                               atol=1e-5)
    assert not torch.allclose(r, p)
    # one angle per cloud: the clouds turn by different angles
    ang = [torch.atan2(r[b, 0, (axis + 2) % 3], r[b, 0, (axis + 1) % 3])
           - torch.atan2(p[b, 0, (axis + 2) % 3], p[b, 0, (axis + 1) % 3])
           for b in range(3)]
    assert len({round(float(a) % (2 * math.pi), 4) for a in ang}) == 3


def test_random_dropout_keeps_ratio_range_and_first_point_fill():
    p = torch.from_numpy(_clouds(3, b=8, n=2000)[0])
    for seed, max_ratio in ((0, 0.875), (1, 0.3)):
        out = ta.random_dropout(p, _gen(seed), max_ratio)
        assert out.shape == p.shape
        for b in range(p.shape[0]):
            changed = (out[b] != p[b]).any(dim=-1)
            # every dropped point becomes the cloud's first point
            assert torch.all(out[b][changed] == p[b, 0])
            # the rest stay where they were
            assert torch.equal(out[b][~changed], p[b][~changed])
            assert float(changed.float().mean()) < max_ratio + 0.05
    assert torch.equal(ta.random_dropout(p, _gen(), 0.0), p)


def test_shuffle_and_sample_give_permutations_and_subsets():
    p, _ = _clouds(4)
    labels = torch.arange(p.shape[0] * p.shape[1]).reshape(p.shape[:2])
    pt = torch.from_numpy(p)
    sp, sl = ta.shuffle_points(pt, _gen(), labels)
    for b in range(3):
        assert sorted(sl[b].tolist()) == sorted(labels[b].tolist())
        torch.testing.assert_close(sp[b], pt[b][sl[b] - b * p.shape[1]],
                                   rtol=0, atol=0)
    assert not torch.equal(sl, labels)
    single = ta.shuffle_points(pt[0], _gen())
    assert sorted(single[:, 0].tolist()) == sorted(pt[0, :, 0].tolist())
    q, ql = ta.sample_points(pt, _gen(), 1000, labels)
    assert q.shape == (3, 1000, 3) and ql.shape == (3, 1000)
    for b in range(3):
        rows = ql[b] - b * p.shape[1]
        assert 0 <= int(rows.min()) and int(rows.max()) < p.shape[1]
        torch.testing.assert_close(q[b], pt[b][rows], rtol=0, atol=0)
    # with replacement: 1000 draws of 400 points repeat some
    assert len(set(ql[0].tolist())) < 1000


def _scalars(logdir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    acc = EventAccumulator(os.fspath(logdir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_summary_writer_scalars_read_back(tmp_path, capsys):
    writer = SummaryWriter(os.fspath(tmp_path))
    log_metrics(1, {"loss": torch.tensor(2.5), "accuracy": 0.25},
                writer=writer)
    log_metrics(3, {"loss": 1.5}, writer=writer, prefix="eval/")
    writer.close()
    assert json.loads(capsys.readouterr().out.splitlines()[0]) == {
        "step": 1, "loss": 2.5, "accuracy": 0.25}
    got = _scalars(tmp_path)
    assert got == {"loss": [(1, 2.5)], "accuracy": [(1, 0.25)],
                   "eval/loss": [(3, 1.5)]}


def test_tensorboard_flag_logs_the_training_metrics(tmp_path, capsys):
    trainer = train(["--config", "cls_tiny", "--steps", "2", "--device",
                     "cpu", "--tensorboard", os.fspath(tmp_path)])
    assert trainer.step_count == 2
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    got = _scalars(tmp_path)
    steps = [r for r in recs if "split" not in r]
    assert [s for s, _ in got["loss"]] == [r["step"] for r in steps]
    np.testing.assert_allclose([v for _, v in got["loss"]],
                               [r["loss"] for r in steps], rtol=1e-6)
    assert [s for s, _ in got["eval/accuracy"]] == [2]


def test_tensorboard_without_the_package_is_a_noop(tmp_path, capsys,
                                                    monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logdir = tmp_path / "tb"
    writer = SummaryWriter(os.fspath(logdir))
    writer.scalars(1, {"loss": 1.0})
    writer.close()
    trainer = train(["--config", "cls_tiny", "--steps", "2", "--device",
                     "cpu", "--tensorboard", os.fspath(logdir)])
    assert trainer.step_count == 2
    out = capsys.readouterr().out.splitlines()
    notes = [ln for ln in out if "no scalars are written" in ln]
    assert len(notes) == 2 and all(ln.startswith("#") for ln in notes)
    assert [json.loads(ln)["step"] for ln in out
            if ln.startswith("{") and "split" not in ln] == [1, 2]
    assert not logdir.exists()
