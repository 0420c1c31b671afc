"""SceneNN per-point semantic segmentation dataset.

A port of pointwise_tpu/data/scenenn.py: per-scene clouds with xyz, rgb
and NYU-40 per-point labels, on the S3DIS loader's on-disk contract (a
directory of ``*.npy`` arrays (N, 7) = xyz, rgb, label).  Scenes are cut
into blocks by the shared sliding-block machinery (data/s3dis.py) with
rgb-only input features (``in_features=3``).

Without a data directory the procedural NYU-40 stand-in
(``synthetic.scenenn_scene``) is used.  One deliberate difference from the
JAX loader: a data directory that holds no scene raises here, where the
JAX loader falls back to the procedural scenes.
"""

from __future__ import annotations

from pointwise_torch.data import s3dis, synthetic

NYU40_NUM_CLASSES = 40


def load_scenes(data_dir: str | None, *, synthetic_scenes: int = 4,
                seed: int = 0):
    """[(xyz, rgb, label)] per scene, as ``s3dis.load_rooms`` returns them:
    the scenes of ``data_dir``, or ``synthetic_scenes`` procedural ones
    when it is None or empty.  Raises when ``data_dir`` holds no scene."""
    if not data_dir:
        return [synthetic.scenenn_scene(seed + i)
                for i in range(synthetic_scenes)]
    scenes = s3dis.load_rooms(data_dir, synthetic_rooms=0, seed=seed)
    if not scenes:
        raise FileNotFoundError(
            f"{data_dir} holds no scene (*.npy arrays (N, 7) = xyz, rgb, "
            "label); omit the data directory for the procedural scenes")
    return scenes
