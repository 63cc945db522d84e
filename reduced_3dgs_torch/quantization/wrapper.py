"""VectorQuantizeTrainerWrapper and VectorQuantizeTrainer (counterpart of
reduced_3dgs_tpu/quantization/wrapper.py): a QuantizeTrainerWrapper with an
ExcludeZeroSHQuantizer, over a given trainer or over a plain Trainer."""
from __future__ import annotations

from ..trainer import AbstractTrainer, Trainer
from .abc import QuantizeTrainerWrapper
from .exclude_zeros import ExcludeZeroSHQuantizer


def VectorQuantizeTrainerWrapper(
        base_trainer: AbstractTrainer,
        num_clusters: int = 256,
        num_clusters_rotation_re=None,
        num_clusters_rotation_im=None,
        num_clusters_opacity=None,
        num_clusters_scaling=None,
        num_clusters_features_dc=None,
        num_clusters_features_rest=(),
        quantize_from_iter: int = 5000,
        quantize_until_iter: int = 30000,
        quantize_interval: int = 1000,
        treat_as_zero: float = 1e-8,
):
    return QuantizeTrainerWrapper(
        base_trainer,
        ExcludeZeroSHQuantizer(
            num_clusters=num_clusters,
            num_clusters_rotation_re=num_clusters_rotation_re,
            num_clusters_rotation_im=num_clusters_rotation_im,
            num_clusters_opacity=num_clusters_opacity,
            num_clusters_scaling=num_clusters_scaling,
            num_clusters_features_dc=num_clusters_features_dc,
            num_clusters_features_rest=num_clusters_features_rest,
            treat_as_zero=treat_as_zero,
        ),
        quantize_from_iter=quantize_from_iter,
        quantize_until_iter=quantize_until_iter,
        quantize_interval=quantize_interval,
    )


def VectorQuantizeTrainer(
        model, dataset,
        num_clusters: int = 256,
        num_clusters_rotation_re=None,
        num_clusters_rotation_im=None,
        num_clusters_opacity=None,
        num_clusters_scaling=None,
        num_clusters_features_dc=None,
        num_clusters_features_rest=(),
        quantize_from_iter: int = 5000,
        quantize_until_iter: int = 30000,
        quantize_interval: int = 1000,
        treat_as_zero: float = 1e-8,
        **configs):
    return VectorQuantizeTrainerWrapper(
        Trainer(model, dataset, **configs),
        num_clusters=num_clusters,
        num_clusters_rotation_re=num_clusters_rotation_re,
        num_clusters_rotation_im=num_clusters_rotation_im,
        num_clusters_opacity=num_clusters_opacity,
        num_clusters_scaling=num_clusters_scaling,
        num_clusters_features_dc=num_clusters_features_dc,
        num_clusters_features_rest=num_clusters_features_rest,
        quantize_from_iter=quantize_from_iter,
        quantize_until_iter=quantize_until_iter,
        quantize_interval=quantize_interval,
        treat_as_zero=treat_as_zero,
    )
