"""Evaluation CLI: ``python -m pointwise_torch.eval``.

A port of eval.py.  Each flow prints one JSON line with eval.py's metric
names and keys:

  python -m pointwise_torch.eval --config modelnet40_synthetic --votes 12
      classification accuracy and mean class accuracy on the full test set;
      ``--votes R`` sums the logits of R rotations about the up axis;
  python -m pointwise_torch.eval --config s3dis_synthetic_local
      full-scene segmentation by sliding blocks and overlap voting
      (``--stride``, default half the config's block stride): accuracy and
      mIoU;
  python -m pointwise_torch.eval --config s3dis_synthetic_local --streaming
      exact overlap-save streaming instead of voting (locality-only nets);
  python -m pointwise_torch.eval --config shapenetpart
      part accuracy and instance mIoU over each category's part set.

SceneNN configs evaluate through the segmentation flows on the NYU-40
scenes.  Weights: ``--checkpoint-dir`` (the newest checkpoint of ``python -m
pointwise_torch.train``), ``--params`` (an ``.npz`` of JAX-layout arrays,
see convert.py), or, with neither, the fresh weights of the config's seed.
The convs run in the Hopper kernels on the card; ``--device cpu`` runs
their plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from pointwise_torch import convert, resolve_device
from pointwise_torch.data import modelnet, s3dis, scenenn, shapenetpart
from pointwise_torch.infer import layered_apply, load_weights, scene_features
from pointwise_torch.streaming import stream_apply_layered
from pointwise_torch.train import cli, get_config
from pointwise_torch.train.configs import ClassificationConfig
from pointwise_torch.utils.metrics import segmentation_metrics


def _load_weights(model, args, load_jax, device):
    """``model`` on ``device`` in eval mode, with the weights of
    ``--checkpoint-dir``, of ``--params`` (through ``load_jax``, a
    convert.py loader) or, with neither, its fresh init."""
    src = load_weights(model, load_jax, args.checkpoint_dir, args.params)
    print(f"# {src or 'no checkpoint dir: evaluating fresh params'}",
          flush=True)
    return model.to(device).eval()


def _pad_batch(batch: dict, batch_size: int):
    """A final partial batch padded to ``batch_size`` by repeating its last
    row (the full test set: no sample is dropped); returns (padded batch,
    true size)."""
    n = len(next(iter(batch.values())))
    if n == batch_size:
        return batch, n
    reps = batch_size - n
    return {k: np.concatenate([v, np.repeat(v[-1:], reps, axis=0)])
            for k, v in batch.items()}, n


def _tensor(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def eval_classification(cfg: ClassificationConfig, args, device):
    data = modelnet.load_modelnet40(
        cfg.data_dir or args.data_dir, "test", cfg.num_points,
        synthetic_size=256, seed=cfg.seed, variant=cfg.variant)
    if data.num_classes > cfg.num_classes:
        # more classes in the data than the config: the head must widen
        cfg = dataclasses.replace(cfg, num_classes=data.num_classes)
    elif data.num_classes < cfg.num_classes:
        # the checkpoint was trained with the config's head: keep it
        print(f"# note: data has {data.num_classes} classes; keeping the "
              f"config's {cfg.num_classes}-way head", flush=True)
    model = _load_weights(cli.build_classifier(cfg, device)[0], args,
                          convert.load_classifier, device)
    votes = max(1, args.votes)
    rots = []
    for v in range(votes):
        theta = 2 * np.pi * v / votes
        c, s = np.cos(theta), np.sin(theta)
        rots.append(_tensor(np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                                       np.float32), device))
    preds, labs = [], []
    for batch in modelnet.batches(data, cfg.batch_size, shuffle=False,
                                  drop_remainder=False):
        batch, nb = _pad_batch(batch, cfg.batch_size)
        pts = _tensor(batch["points"], device)
        with torch.inference_mode():
            logits = sum(model(pts @ rot) for rot in rots)
        preds.append(logits.argmax(-1).cpu().numpy()[:nb])
        labs.append(batch["label"][:nb])
    pred, lab = np.concatenate(preds), np.concatenate(labs)
    acc = int((pred == lab).sum()) / max(len(pred), 1)
    mca = segmentation_metrics(pred, lab,
                               cfg.num_classes)["mean_class_accuracy"]
    print(json.dumps({"metric": "classification_accuracy", "value": acc,
                      "mean_class_accuracy": round(mca, 6),
                      "votes": votes, "n": len(pred)}), flush=True)
    return acc


def _segmenter(cfg, args, device):
    return _load_weights(cli.build_segmenter(cfg, device)[0], args,
                         convert.load_segmenter, device)


def _scene_metrics(metric, preds, labs, cfg, n_scenes):
    m = s3dis.iou_metrics(np.concatenate(preds), np.concatenate(labs),
                          cfg.num_classes)
    print(json.dumps({"metric": metric, "accuracy": m["accuracy"],
                      "miou": m["miou"], "scenes": n_scenes}), flush=True)
    return m


def eval_segmentation_streaming(cfg, args, device, scenes):
    """Exact full-scene eval by overlap-save streaming (halo = the sum of
    the radii): per-point logits equal the full-scene forward, the
    bias-free counterpart of block voting.  Needs a locality-only net."""
    if cfg.global_context:
        raise SystemExit(
            f"--streaming needs a locality-only net, but config "
            f"{cfg.name!r} trains with global_context=True (its head "
            f"shapes include the pooled features).  Train/evaluate a "
            f"*_local variant instead (e.g. s3dis_synthetic_local, "
            f"scenenn_local), or use block voting for this checkpoint.")
    model = _segmenter(cfg, args, device)
    halo = float(sum(cfg.radii))
    preds, labs = [], []
    for i, (xyz, rgb, lab) in enumerate(scenes):
        logits = stream_apply_layered(
            layered_apply(model), xyz, scene_features(cfg, xyz, rgb),
            radii=cfg.radii, tile_size=max(2.0 * halo, cfg.block_size),
            out_dim=cfg.num_classes, device=device)
        pred = logits.argmax(axis=1).astype(np.int32)
        m = s3dis.iou_metrics(pred, lab, cfg.num_classes)
        print(f"# scene {i} (streaming): acc={m['accuracy']:.4f} "
              f"miou={m['miou']:.4f}", flush=True)
        preds.append(pred)
        labs.append(lab)
    return _scene_metrics("segmentation_streaming", preds, labs, cfg,
                          len(scenes))


def block_predictor(model, device):
    """The ``predict_logits`` that ``s3dis.predict_scene_voting`` calls:
    one batch of blocks (numpy points, features, mask) through ``model`` in
    inference mode on ``device``, its logits fetched to the host as
    numpy."""

    def predict(points, features, mask):
        with torch.inference_mode():
            return model(_tensor(points, device), _tensor(features, device),
                         _tensor(mask, device)).cpu().numpy()

    return predict


def eval_segmentation(cfg, args, device):
    if cfg.name.startswith("scenenn"):
        scenes = scenenn.load_scenes(cfg.data_dir or args.data_dir,
                                     seed=cfg.seed)
    else:
        scenes = s3dis.load_rooms(cfg.data_dir or args.data_dir,
                                  seed=cfg.seed)
    if args.streaming:
        return eval_segmentation_streaming(cfg, args, device, scenes)
    predict = block_predictor(_segmenter(cfg, args, device), device)
    # voting density: denser than the training stride by default
    stride = args.stride if args.stride is not None else cfg.block_stride / 2
    if stride <= 0:
        raise SystemExit(f"--stride must be > 0, got {stride}")
    preds, labs = [], []
    for i, (xyz, rgb, lab) in enumerate(scenes):
        res = s3dis.predict_scene_voting(
            predict, xyz, rgb, num_classes=cfg.num_classes,
            num_points=cfg.num_points, block_size=cfg.block_size,
            stride=stride, batch_size=cfg.batch_size, label=lab,
            feature_mode="rgb" if cfg.in_features == 3 else "rgb_norm")
        m = s3dis.iou_metrics(res["pred"], lab, cfg.num_classes)
        print(f"# scene {i}: acc={m['accuracy']:.4f} miou={m['miou']:.4f} "
              f"covered={res['covered'].mean():.3f}", flush=True)
        preds.append(res["pred"])
        labs.append(lab)
    return _scene_metrics("segmentation", preds, labs, cfg, len(scenes))


def eval_shapenetpart(cfg, args, device):
    data = shapenetpart.load_shapenetpart(
        cfg.data_dir or args.data_dir, "test", cfg.num_points,
        synthetic_size=64, seed=cfg.seed, variant=cfg.variant)
    model = _load_weights(cli.build_partseg(cfg, data, device)[0], args,
                          convert.load_shapenetpart, device)
    preds, labs, cats = [], [], []
    for batch in shapenetpart.batches(data, cfg.batch_size, shuffle=False,
                                      drop_remainder=False):
        batch, nb = _pad_batch(batch, cfg.batch_size)
        with torch.inference_mode():
            logits = model(_tensor(batch["points"], device),
                           _tensor(batch["category"], device))
        preds.append(logits.argmax(-1).cpu().numpy()[:nb])
        labs.append(batch["label"][:nb])
        cats.append(batch["category"][:nb])
    pred, lab, cat = (np.concatenate(a) for a in (preds, labs, cats))
    acc = float((pred == lab).mean())
    # each shape averaged over its category's FULL part set
    miou = shapenetpart.category_miou(
        pred, lab, cat, parts_per_category=data.parts_per_category)
    print(json.dumps({"metric": "shapenetpart", "accuracy": acc,
                      "instance_miou": miou, "n": len(cat)}), flush=True)
    return miou


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m pointwise_torch.eval")
    ap.add_argument("--config", default="modelnet40_synthetic")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="evaluate the newest checkpoint that "
                         "python -m pointwise_torch.train wrote here")
    ap.add_argument("--params", default=None,
                    help="JAX-layout weights (.npz keyed by flattened param "
                         "path)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--votes", type=int, default=1,
                    help="rotation votes for classification eval")
    ap.add_argument("--stride", type=float, default=None,
                    help="segmentation voting stride (default: half the "
                         "config's block_stride)")
    ap.add_argument("--streaming", action="store_true",
                    help="segmentation: exact overlap-save streaming instead"
                         " of block voting (needs a locality-only net)")
    ap.add_argument("--norm", default=None, choices=["layer", "batch", "none"],
                    help="override the config's normalization: must match "
                         "the weights' training flag (train --norm)")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the CLI; returns the flow's headline metric."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.config)
    if args.norm:
        cfg = dataclasses.replace(cfg, norm=args.norm)
    print(f"# eval config={args.config} device={device}", flush=True)
    if isinstance(cfg, ClassificationConfig):
        return eval_classification(cfg, args, device)
    if cfg.name.startswith("shapenetpart"):
        return eval_shapenetpart(cfg, args, device)
    return eval_segmentation(cfg, args, device)


if __name__ == "__main__":
    main()
