"""Factories and the training-mode registry (counterpart of
reduced_3dgs_tpu/prepare.py:36-128).

``modes`` maps each of the ten training modes to its trainer constructor,
the JAX package's compositions from ``combinations.py``; ``prepare_trainer``
wraps it with the scale regulariser (``with_scale_reg``) and the
vector-quantizing wrapper (``quantize``), in the JAX package's order. The
``camera-*`` modes learn each camera's pose beside the model
(``trainer.camera_trainer``) and take the camera-trainable model class.

Backends: ``cuda``, ``inria`` and ``gsplat`` render the 3DGS model through
the port's CUDA compositors; ``gsplat-2dgs`` takes the 2DGS model classes,
which render surfels (``ops/rasterize/twodgs.py``) in every mode.
"""
from __future__ import annotations

from .combinations import (CameraFullPruningTrainer,
                           CameraOpacityResetFullReducedDensificationTrainer,
                           CameraSHCullingFullPruningTrainer,
                           CameraSHCullingOpacityResetDensificationTrainer,
                           CameraSHCullingOpacityResetFullReducedDensificationTrainer,
                           FullPruningTrainer, OpacityResetFullReducedDensificationTrainer,
                           SHCullingFullPruningTrainer,
                           SHCullingOpacityResetDensificationTrainer,
                           SHCullingOpacityResetFullReducedDensificationTrainer)
from .dataset.colmap import colmap_init
from .quantization import VectorQuantizeTrainerWrapper
from .shculling import (CameraTrainableVariableSHGaussianModel,
                        CameraTrainableVariableSHGsplat2DGSGaussianModel,
                        VariableSHGaussianModel, VariableSHGsplat2DGSGaussianModel)
from .trainer.extensions import ScaleRegularizeTrainerWrapper

backends = ["cuda", "inria", "gsplat", "gsplat-2dgs"]

modes = {
    "densify-shculling": SHCullingOpacityResetDensificationTrainer,
    "pruning": FullPruningTrainer,
    "pruning-shculling": SHCullingFullPruningTrainer,
    "densify-pruning": OpacityResetFullReducedDensificationTrainer,
    "densify-pruning-shculling": SHCullingOpacityResetFullReducedDensificationTrainer,
    "camera-densify-shculling": CameraSHCullingOpacityResetDensificationTrainer,
    "camera-pruning": CameraFullPruningTrainer,
    "camera-pruning-shculling": CameraSHCullingFullPruningTrainer,
    "camera-densify-pruning": CameraOpacityResetFullReducedDensificationTrainer,
    "camera-densify-pruning-shculling":
        CameraSHCullingOpacityResetFullReducedDensificationTrainer,
}


def get_gaussian_model_class(backend: str, trainable_camera: bool = False):
    if backend == "gsplat-2dgs":
        return (CameraTrainableVariableSHGsplat2DGSGaussianModel if trainable_camera
                else VariableSHGsplat2DGSGaussianModel)
    if backend in backends:
        return (CameraTrainableVariableSHGaussianModel if trainable_camera
                else VariableSHGaussianModel)
    raise ValueError(f"Unknown backend: {backend}")


def prepare_gaussians(sh_degree: int, source: str, device="cuda", trainable_camera: bool = False,
                      load_ply: str = None, backend: str = "cuda"):
    """The model on ``device``, from ``load_ply`` or else from the COLMAP
    sparse points of ``source``."""
    gaussians = get_gaussian_model_class(backend, trainable_camera)(sh_degree, device=device)
    if load_ply:
        return gaussians.load_ply(load_ply)
    return colmap_init(gaussians, source)


def prepare_quantizer(
        gaussians,
        dataset,
        base_constructor,
        load_quantized: str = None,
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
        **configs):
    trainer = VectorQuantizeTrainerWrapper(
        base_constructor(gaussians, dataset=dataset, **configs),
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
    )
    if load_quantized:
        n = gaussians.num_points
        trainer.quantizer.load_quantized(trainer.model, load_quantized)
        if gaussians.num_points != n:
            # The trainer's state was sized for the model it was built over.
            raise ValueError(f"{load_quantized} holds {gaussians.num_points} Gaussians and "
                             f"the model {n}: start from the PLY saved beside it (-l)")
    return trainer, trainer.quantizer


def prepare_trainer(gaussians, dataset, mode: str, with_scale_reg: bool = False,
                    quantize: bool = False, load_quantized: str = None, configs=None):
    """(trainer, quantizer or None) of ``mode``."""
    configs = dict(configs or {})
    constructor = modes[mode]
    if with_scale_reg:
        base_mode = modes[mode]
        constructor = (lambda model, dataset, **cfg:
                       ScaleRegularizeTrainerWrapper(base_mode, model, dataset, **cfg))
    if quantize:
        return prepare_quantizer(gaussians, dataset=dataset, base_constructor=constructor,
                                 load_quantized=load_quantized, **configs)
    return constructor(gaussians, dataset=dataset, **configs), None
