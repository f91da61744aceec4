"""Tensor ops of the port: color, remapping, pyramids, steerable
features, feature assembly and PCA."""

from .color import luminance, rgb_to_yiq, yiq_to_rgb
from .features import assemble_features, extract_patches, feature_weights
from .pca import fit_and_project, pca_basis, project
from .pyramid import build_pyramid, downsample, gaussian_blur, upsample
from .remap import luminance_stats, remap_luminance
from .steerable import steerable_responses

__all__ = [
    "assemble_features",
    "build_pyramid",
    "downsample",
    "extract_patches",
    "feature_weights",
    "fit_and_project",
    "gaussian_blur",
    "luminance",
    "luminance_stats",
    "pca_basis",
    "project",
    "remap_luminance",
    "rgb_to_yiq",
    "steerable_responses",
    "upsample",
    "yiq_to_rgb",
]
