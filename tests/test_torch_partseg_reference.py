"""The part segmenter against the benchmark's plain reference, on the CPU.

``ShapeNetPartSegmenter`` on the port's plain CPU path with its convs in
float32 against ``benchmark/reference/partseg.py`` on the same seeded
weights (``benchmark.partseg.make_weights``), the same dropout draws and a
masked tail: logits, the masked loss and every parameter's gradient.  And
the forward's two spans: one range each under a profiler, none without,
and the same logits either way.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity

from benchmark import partseg as bench_partseg
from benchmark.reference import models as ref_models
from benchmark.reference.partseg import partseg_logits
from pointwise_torch.models import ShapeNetPartSegmenter
from pointwise_torch.models.segmenter import segmentation_loss
from pointwise_torch.utils import runtime

# Both sides compute in float32 with the same operations in other orders
# (the port's cell sums against the reference's masked products, its
# concatenations against the reference's): test_harness_reference.py's
# 2e-5 of the largest magnitude holds them, some hundred float32 ulps.
TOL = 2e-5
CFG = dict(in_features=3, channels=[8] * 6,
           radii=[0.1, 0.15, 0.2, 0.3, 0.4, 0.6], head_dims=[16, 8],
           num_classes=50, num_categories=16, dropout=0.3)
SPANS = ("partseg.context", "partseg.head")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(seed=3):
    model = ShapeNetPartSegmenter(
        num_parts=CFG["num_classes"], num_categories=CFG["num_categories"],
        in_features=3, channels=CFG["channels"], radii=CFG["radii"],
        head_dims=CFG["head_dims"], dropout_rate=CFG["dropout"],
        precision="float32", device="cpu")
    w = bench_partseg.make_weights(CFG, seed, "cpu")
    model.load_state_dict(w, strict=True)
    return model, w


def _batch(categories, seed=0):
    """2 shapes of 96 points in the unit sphere; the second's last 20
    points masked out."""
    g = torch.Generator().manual_seed(seed)
    pts = torch.rand((2, 96, 3), generator=g) * 2.0 - 1.0
    pts = pts / pts.norm(dim=-1).max()
    label = torch.randint(0, CFG["num_classes"], (2, 96), generator=g)
    mask = torch.ones(2, 96)
    mask[1, 76:] = 0.0
    return pts, torch.tensor(categories), label, mask


def _close(a, b, tol=TOL):
    a, b = a.detach(), b.detach()
    assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def test_weights_are_the_models_parameters():
    model, w = _model()
    assert set(w) == set(model.state_dict())
    assert w["embed.weight"].shape == (64, CFG["num_categories"])


@pytest.mark.parametrize("categories", [(2 * c, 2 * c + 1)
                                        for c in range(8)])
def test_matches_the_reference_in_float32(categories):
    """Every one of the 16 categories across the cases, each through its
    own column of the embedding."""
    model, w = _model()
    pts, cat, label, mask = _batch(categories, seed=categories[0])
    model.train()
    torch.manual_seed(11)
    logits = model(pts, cat, mask=mask)
    loss, _ = segmentation_loss(logits, label, mask)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))

    p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    torch.manual_seed(11)
    ref = partseg_logits(p, CFG["radii"], pts, cat, mask, CFG["dropout"])
    ref_loss = ref_models.segmentation_loss(ref, label, mask)
    ref_grads = torch.autograd.grad(ref_loss, [p[k] for k in params])

    _close(logits, ref)
    assert float(logits[1, 76:].detach().abs().max()) == 0.0
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()),
                                                rel=TOL)
    for k, a, b in zip(params, grads, ref_grads):
        assert float(b.abs().max()) > 0.0, k
        _close(a, b)
    emb = grads[list(params).index("embed.weight")]
    cols = emb.abs().sum(dim=0) > 0     # a column for each category present
    assert cols.nonzero()[:, 0].tolist() == sorted(set(categories))


def test_spans_under_a_profiler():
    model, _ = _model()
    model.eval()
    pts, cat, _, mask = _batch((4, 9))
    with torch.no_grad():
        with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
            model(pts, cat, mask=mask)
    names = [e.name for e in prof.events()]
    for name in SPANS:
        assert names.count(name) == 1, name


def test_no_range_without_a_profiler(monkeypatch):
    model, _ = _model()
    model.eval()
    pts, cat, _, mask = _batch((4, 9))
    with torch.no_grad():
        with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
            traced = model(pts, cat, mask=mask)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(runtime, "record_function", refuse)
    with torch.no_grad():
        plain = model(pts, cat, mask=mask)
    assert torch.equal(plain, traced)
