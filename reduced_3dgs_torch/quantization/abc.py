"""Quantizer abstractions (counterpart of reduced_3dgs_tpu/quantization/abc.py:18-59).

``AbstractQuantizer`` quantizes a model's attributes to codebooks and ids,
dequantizes them back into the model, and writes and reads the quantized
PLY. ``QuantizeTrainerWrapper`` makes training codebook-aware: reading its
``model`` property quantizes and dequantizes the live parameters in place
when the step count is a multiple of ``quantize_interval`` inside
[``quantize_from_iter``, ``quantize_until_iter``], and
``AbstractTrainer.step`` reads that property before every update. Under a
sharded engine every rank quantizes, and rank 0's dequantized parameters
then overwrite the others': K-Means' centroid sums are float atomics on the
card, so the replicas' codebooks may differ in the last bit.

Not ported: ``fires_at``, which sizes the JAX package's fused multi-step
windows; the port takes one step per call.
"""
from __future__ import annotations

import abc
from typing import Dict, Tuple

from ..trainer import AbstractTrainer, TrainerWrapper


class AbstractQuantizer(abc.ABC):

    @abc.abstractmethod
    def quantize(self, model, update_codebook: bool = True) -> Tuple[Dict, Dict]:
        ...

    @abc.abstractmethod
    def dequantize(self, model, ids_dict: Dict, codebook_dict: Dict, xyz=None,
                   replace: bool = False):
        ...

    @abc.abstractmethod
    def save_quantized(self, model, ply_path: str):
        ...

    @abc.abstractmethod
    def load_quantized(self, model, ply_path: str):
        ...


class QuantizeTrainerWrapper(TrainerWrapper):

    def __init__(self, base_trainer: AbstractTrainer, quantizer: AbstractQuantizer,
                 quantize_from_iter: int = 5000, quantize_until_iter: int = 30000,
                 quantize_interval: int = 1000):
        super().__init__(base_trainer)
        self.quantizer = quantizer
        self.quantize_from_iter = quantize_from_iter
        self.quantize_until_iter = quantize_until_iter
        self.quantize_interval = quantize_interval

    def fires(self, step: int) -> bool:
        return (self.quantize_from_iter <= step <= self.quantize_until_iter
                and step % self.quantize_interval == 0)

    @property
    def model(self):
        model = self.base_trainer.model
        if self.fires(self.curr_step):
            ids_dict, codebook_dict = self.quantizer.quantize(model, update_codebook=True)
            model = self.quantizer.dequantize(model, ids_dict, codebook_dict)
            mesh = getattr(self.engine, "mesh", None)
            if mesh is not None:
                mesh.broadcast([p.detach() for p in model.param_dict().values()])
        return model
