"""Evaluation (port of custom_diffusion360_tpu/eval/): the FID InceptionV3
feature extractor, Frechet-distance statistics on the host, and CLIP
image/text similarity over the port's CLIP towers; ``cli/evaluate.py``
drives them.
"""
from .clip_score import clip_image_similarity, clip_score  # noqa: F401
from .fid import FeatureStats, fid_from_stats, frechet_distance  # noqa: F401
