"""Codebook (K-Means) vector quantization of a model's attributes, and the
quantized PLY (counterpart of reduced_3dgs_tpu/quantization/quantizer.py:30-377).

One codebook per attribute, clustered by ``ops.kmeans``:

  * ``features_dc``: the DC colour [N, 3];
  * ``features_rest_d`` for each SH band d: the band's coefficients of each
    colour channel, one row per (Gaussian, channel) in channel-major order,
    so its ids are [N, 3];
  * ``rotation_re`` and ``rotation_im``: the real and the imaginary part of
    the normalised rotation;
  * ``opacity``, in logit space;
  * ``scaling``, clustered in activated space and stored in log space (a
    warm codebook is activated before it seeds K-Means).

An update whose codebook from the last event has at least K rows starts
warm and runs ``warm_max_iter`` Lloyd iterations; otherwise ``max_iter``.

The quantized PLY holds per Gaussian x, y, z, zero normals and one code per
attribute (``f_rest_d_c`` per band and channel), then one float32 element
per codebook, with the JAX package's element names and field order: files
of equal codebooks and ids are byte-identical. Code widths differ from the
JAX package's only where its codes wrap (``compute_uint_dtype``); its
reader takes each field's type from the header and loads these files.

``load_quantized`` sets every SH degree of a model that has them to the
maximum. The JAX package leaves ``_degrees`` empty there, and its model
cannot render after the load. The ExcludeZero codebooks keep culled
coefficients exactly 0, so the render is the same.

Not ported: the capacity padding of ``dequantize`` (the port keeps N rows).
"""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models import ply as plyio
from ..models.gaussian_model import normalized_rotation
from ..ops.kmeans import assign, kmeans
from .abc import AbstractQuantizer

REST_PREFIX = "features_rest_"


def compute_uint_dtype(n: int) -> str:
    """The narrowest of u1, u2 and u4 that holds the codes 0 .. n - 1.

    The JAX package takes floor(log2 n) bits: its codes wrap for n in
    257-511 and 65,537-131,071 (code 299 of n = 300 is stored as 43), and
    from 131,072 it names a type numpy does not have ("u3"). Wherever its
    codes fit, the two widths agree."""
    bits = max(int(n) - 1, 1).bit_length()
    for nbytes in (1, 2, 4):
        if bits <= 8 * nbytes:
            return f"u{nbytes}"
    raise ValueError(f"{n} clusters need codes wider than 32 bits")


def _band(degree: int) -> Tuple[int, int]:
    """The rest-coefficient columns [lo, hi) of SH band ``degree + 1``."""
    return (degree + 1) ** 2 - 1, (degree + 2) ** 2 - 1


def _ids_shape(key: str, ids: torch.Tensor) -> torch.Tensor:
    if key == "features_dc":
        return ids[:, None]
    if key.startswith(REST_PREFIX):
        return ids.reshape(-1, 3)
    return ids


class VectorQuantizer(AbstractQuantizer):

    def __init__(
            self,
            num_clusters: int = 256,
            num_clusters_rotation_re: Optional[int] = None,
            num_clusters_rotation_im: Optional[int] = None,
            num_clusters_opacity: Optional[int] = None,
            num_clusters_scaling: Optional[int] = None,
            num_clusters_features_dc: Optional[int] = None,
            num_clusters_features_rest=(),
            max_sh_degree: int = 3,
            force_code_dtype: Optional[str] = None,
            force_codebook_dtype: str = "f4",
            tol: float = 1e-4, max_iter: int = 300,
            warm_max_iter: int = 15, seed: int = 0):
        self.num_clusters_rotation_re = num_clusters_rotation_re or num_clusters
        self.num_clusters_rotation_im = num_clusters_rotation_im or num_clusters
        self.num_clusters_opacity = num_clusters_opacity or num_clusters
        self.num_clusters_scaling = num_clusters_scaling or num_clusters
        self.num_clusters_features_dc = num_clusters_features_dc or num_clusters
        nfr = list(num_clusters_features_rest or [])
        self.num_clusters_features_rest = [nfr[i] if len(nfr) > i else num_clusters
                                           for i in range(max_sh_degree)]
        self.force_code_dtype = force_code_dtype
        self.force_codebook_dtype = force_codebook_dtype
        self.tol = tol
        self.max_iter = max_iter
        self.warm_max_iter = warm_max_iter
        self.seed = seed
        self._codebook_dict: Dict[str, torch.Tensor] = {}

    # --- attributes ---------------------------------------------------------
    @staticmethod
    def keys(model):
        """The attributes, in the order they are clustered."""
        return ["features_dc", *(f"{REST_PREFIX}{d}" for d in range(model.max_sh_degree)),
                "rotation_re", "rotation_im", "opacity", "scaling"]

    def num_clusters_of(self, key: str) -> int:
        if key.startswith(REST_PREFIX):
            return self.num_clusters_features_rest[int(key[len(REST_PREFIX):])]
        return getattr(self, f"num_clusters_{key}")

    @staticmethod
    def values(model, key: str) -> torch.Tensor:
        """[rows, D] values clustered for attribute ``key`` (scaling activated)."""
        if key == "features_dc":
            return model._features_dc.detach()[:, 0, :]
        if key.startswith(REST_PREFIX):
            fr = model._features_rest.detach()
            lo, hi = _band(int(key[len(REST_PREFIX):]))
            return fr.transpose(1, 2).reshape(-1, fr.shape[1])[:, lo:hi]
        if key in ("rotation_re", "rotation_im"):
            rot = normalized_rotation(model._rotation.detach())
            return rot[:, :1] if key == "rotation_re" else rot[:, 1:]
        if key == "opacity":
            return model._opacity.detach()
        if key == "scaling":
            return torch.exp(model._scaling.detach())
        raise KeyError(key)

    # --- K-Means ------------------------------------------------------------
    def generate_codebook(self, values, num_clusters, init_codebook=None):
        warm = init_codebook is not None and init_codebook.shape[0] >= int(num_clusters)
        return kmeans(values, int(num_clusters), init_centers=init_codebook,
                      max_iter=self.warm_max_iter if warm else self.max_iter, tol=self.tol,
                      seed=self.seed)

    @staticmethod
    def one_nearest(points, codebook):
        if codebook.shape[0] <= 1:
            return torch.zeros((points.shape[0],), dtype=torch.int64, device=points.device)
        return assign(points, codebook)

    def produce_clusters_of(self, model, key: str, init_codebook=None):
        """(codebook, ids) of attribute ``key`` from K-Means, warm-started
        from ``init_codebook`` (stored form) when given."""
        vals = self.values(model, key)
        if init_codebook is not None:
            init_codebook = torch.as_tensor(init_codebook, dtype=vals.dtype, device=vals.device)
            if key == "scaling":
                init_codebook = torch.exp(init_codebook)
        cb, ids = self.generate_codebook(vals, self.num_clusters_of(key), init_codebook)
        return (torch.log(cb) if key == "scaling" else cb), _ids_shape(key, ids)

    def find_nearest_cluster_id_of(self, model, key: str, codebook):
        if key == "scaling":
            codebook = torch.exp(codebook)
        return _ids_shape(key, self.one_nearest(self.values(model, key), codebook))

    def produce_clusters(self, model, init_codebook_dict=None):
        init = init_codebook_dict or {}
        cb, ids = {}, {}
        for key in self.keys(model):
            cb[key], ids[key] = self.produce_clusters_of(model, key, init.get(key))
        return cb, ids

    def find_nearest_cluster_id(self, model, codebook_dict):
        return {key: self.find_nearest_cluster_id_of(model, key, codebook_dict[key])
                for key in self.keys(model)}

    # --- quantize / dequantize ------------------------------------------------
    def quantize(self, model, update_codebook: bool = True) -> Tuple[Dict, Dict]:
        if not self._codebook_dict or update_codebook:
            codebook_dict, ids_dict = self.produce_clusters(model, self._codebook_dict)
            self._codebook_dict = codebook_dict
        else:
            codebook_dict = self._codebook_dict
            ids_dict = self.find_nearest_cluster_id(model, codebook_dict)
        return ids_dict, codebook_dict

    @torch.no_grad()
    def dequantize(self, model, ids_dict, codebook_dict, xyz=None, replace: bool = False):
        """Set the model's parameters to the codebook rows of ``ids_dict``
        (and its centres to ``xyz`` when given). ``replace`` is for a model
        being loaded: its row count becomes the ids', and every SH degree
        the maximum."""
        dev = model._xyz.device
        cb = {k: torch.as_tensor(v, device=dev) for k, v in codebook_dict.items()}
        ids = {k: torch.as_tensor(v, device=dev).long() for k, v in ids_dict.items()}
        rest = [cb[f"{REST_PREFIX}{d}"][ids[f"{REST_PREFIX}{d}"]]
                for d in range(model.max_sh_degree)]
        params = {k: v.detach() for k, v in model.param_dict().items()}
        if xyz is not None:
            params["xyz"] = torch.as_tensor(xyz, dtype=torch.float32, device=dev)
        params.update(
            opacity=cb["opacity"][ids["opacity"]],
            scaling=cb["scaling"][ids["scaling"]],
            rotation=torch.cat([cb["rotation_re"][ids["rotation_re"]],
                                cb["rotation_im"][ids["rotation_im"]]], dim=1),
            features_dc=cb["features_dc"][ids["features_dc"]],
            features_rest=torch.cat(rest, dim=2).transpose(1, 2).contiguous())
        model.set_parameters(params)
        if replace:
            model.aux_set(model.aux_for_new_points(model.num_points))
        return model

    # --- the quantized PLY -----------------------------------------------------
    def _code_dtype(self, n_clusters: int) -> str:
        return self.force_code_dtype or compute_uint_dtype(n_clusters)

    def save_quantized(self, model, ply_path: str):
        os.makedirs(os.path.dirname(ply_path) or ".", exist_ok=True)
        ids_dict, codebook_dict = self.quantize(model, update_codebook=False)
        ids = {k: v.cpu().numpy() for k, v in ids_dict.items()}
        n = model.num_points
        xyz = model._xyz.detach().cpu().numpy()

        fields = OrderedDict()
        fields["x"], fields["y"], fields["z"] = (xyz[:, i].astype("<f4") for i in range(3))
        for nm in ("nx", "ny", "nz"):
            fields[nm] = np.zeros(n, "<f4")
        for name, key in (("rot_re", "rotation_re"), ("rot_im", "rotation_im"),
                          ("opacity", "opacity"), ("scale", "scaling")):
            fields[name] = ids[key].astype(self._code_dtype(self.num_clusters_of(key)))
        fields["f_dc"] = ids["features_dc"][:, 0].astype(
            self._code_dtype(self.num_clusters_features_dc))
        for d in range(model.max_sh_degree):
            dt = self._code_dtype(self.num_clusters_features_rest[d])
            for ch in range(3):
                fields[f"f_rest_{d}_{ch}"] = ids[f"{REST_PREFIX}{d}"][:, ch].astype(dt)

        def cb_struct(arr, prefix):
            arr = arr.detach().cpu().numpy().astype(self.force_codebook_dtype)
            names = [prefix] if arr.shape[1] == 1 else [f"{prefix}_{i}"
                                                        for i in range(arr.shape[1])]
            cols = OrderedDict((nm, arr[:, i]) for i, nm in enumerate(names))
            return plyio.fields_to_struct(cols, names)

        elements = OrderedDict()
        elements["vertex"] = plyio.fields_to_struct(fields, list(fields))
        for element, key, prefix in (("rot_re", "rotation_re", "rot_re"),
                                     ("rot_im", "rotation_im", "rot_im"),
                                     ("opacity", "opacity", "opacity"),
                                     ("scaling", "scaling", "scaling"),
                                     ("f_dc", "features_dc", "f_dc")):
            elements[f"codebook_{element}"] = cb_struct(codebook_dict[key], prefix)
        for d in range(model.max_sh_degree):
            elements[f"codebook_f_rest_{d}"] = cb_struct(codebook_dict[f"{REST_PREFIX}{d}"],
                                                         f"f_rest_{d}")
        plyio.write_ply(ply_path, elements)

    @staticmethod
    def parse_ids(elements, max_sh_degree: int) -> Dict[str, torch.Tensor]:
        v = elements["vertex"]

        def codes(*names):
            return torch.from_numpy(np.stack([v[nm].astype(np.int64) for nm in names], 1))

        ids = {"rotation_re": codes("rot_re")[:, 0], "rotation_im": codes("rot_im")[:, 0],
               "opacity": codes("opacity")[:, 0], "scaling": codes("scale")[:, 0],
               "features_dc": codes("f_dc")}
        for d in range(max_sh_degree):
            ids[f"{REST_PREFIX}{d}"] = codes(*(f"f_rest_{d}_{ch}" for ch in range(3)))
        return ids

    @staticmethod
    def parse_codebook(elements, max_sh_degree: int) -> Dict[str, torch.Tensor]:
        def columns(element, *names):
            e = elements[element]
            return torch.from_numpy(np.stack([e[nm] for nm in names], 1).astype(np.float32))

        cb = {"rotation_re": columns("codebook_rot_re", "rot_re"),
              "rotation_im": columns("codebook_rot_im", *(f"rot_im_{c}" for c in range(3))),
              "opacity": columns("codebook_opacity", "opacity"),
              "scaling": columns("codebook_scaling", *(f"scaling_{c}" for c in range(3))),
              "features_dc": columns("codebook_f_dc", *(f"f_dc_{c}" for c in range(3)))}
        for d in range(max_sh_degree):
            lo, hi = _band(d)
            cb[f"{REST_PREFIX}{d}"] = columns(f"codebook_f_rest_{d}",
                                              *(f"f_rest_{d}_{c}" for c in range(hi - lo)))
        return cb

    @staticmethod
    def parse_xyz(elements) -> torch.Tensor:
        v = elements["vertex"]
        return torch.from_numpy(np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32))

    def load_quantized(self, model, ply_path: str):
        elements = plyio.read_ply(ply_path)
        dev = model._xyz.device
        ids_dict = self.parse_ids(elements, model.max_sh_degree)
        self._codebook_dict = {k: v.to(dev) for k, v in
                               self.parse_codebook(elements, model.max_sh_degree).items()}
        return self.dequantize(model, ids_dict, self._codebook_dict,
                               xyz=self.parse_xyz(elements), replace=True)
