"""Spherical layer base: plane <-> sphere projection and embedding rotation.

PyTorch counterpart of ``SphereLayer`` in
``jammy_flows_tpu/layers/sphere.py`` for S2 layers with householder
rotations, on the (z, phi) column path: coordinates travel as tuples of (B,)
columns and parameters as a transposed (P, Bp) slab, and z = cos(theta) rides
between layers, so the rotations' log(sin) terms vanish (dA = dz dphi).  The
(theta, phi) column twins and the row path are not ported; neither are
Moebius, CircularRQSpline and SphericalIdentity (ROADMAP.md, Queue 1:
remaining layers).
"""
from __future__ import annotations

import numpy as np

from .base import FlowLayer
from ..ops import manifold, rotations


class SphereLayer(FlowLayer):
    """Parameter layout: [rotation params] + child params."""

    def __init__(self, dimension=2, euclidean_to_sphere_as_first=1,
                 add_rotation=0, rotation_mode="householder",
                 num_householder_iter=-1,
                 always_parametrize_in_embedding_space=0):
        super().__init__(dimension, always_parametrize_in_embedding_space)
        if dimension != 2:
            raise NotImplementedError(
                "S1 layers are not ported yet (ROADMAP.md, Queue 1: "
                "remaining layers)")
        if always_parametrize_in_embedding_space:
            raise NotImplementedError(
                "embedding-space parametrization is not ported yet "
                "(ROADMAP.md, Queue 1: remaining layers)")
        self.euclidean_to_sphere_as_first = int(euclidean_to_sphere_as_first)
        self.add_rotation = int(add_rotation)
        self.rotation_mode = rotation_mode
        self.num_rotation_params = 0
        self.householder_iter = 0
        if self.add_rotation:
            if rotation_mode != "householder":
                raise NotImplementedError(
                    f"sphere rotation_mode={rotation_mode!r} is not ported "
                    "yet (ROADMAP.md, Queue 1: remaining layers)")
            emb = dimension + 1
            it = emb if num_householder_iter == -1 else num_householder_iter
            self.householder_iter = it
            self.num_rotation_params = it * emb
        self.num_params += self.num_rotation_params

    # -- (z, phi)-carrier column protocol -----------------------------------
    def _rot_vs_cols(self, rot_slab):
        emb = self.dimension + 1
        return [[rot_slab[i * emb + j] for j in range(emb)]
                for i in range(self.householder_iter)]

    def _apply_embedding_rotation_cols_z(self, rot_slab, cols, inverse):
        if not self.add_rotation:
            return cols
        ecols = manifold.zphi_to_eucl_cols(cols[0], cols[1])
        ecols = rotations.householder_apply_cols(self._rot_vs_cols(rot_slab),
                                                 ecols, inverse=inverse)
        return manifold.eucl_to_zphi_cols(*ecols)

    def forward_cols_z(self, slab, cols, log_det):
        rot = slab[:self.num_rotation_params]
        child = slab[self.num_rotation_params:]
        if self.euclidean_to_sphere_as_first:
            z, phi, log_det = manifold.plane_to_zsphere2_cols(cols[0], cols[1],
                                                              log_det)
            cols = (z, phi)
        cols, log_det = self._forward_cols_z(child, cols, log_det)
        return self._apply_embedding_rotation_cols_z(rot, cols,
                                                     inverse=False), log_det

    def inverse_cols_z(self, slab, cols, log_det):
        rot = slab[:self.num_rotation_params]
        child = slab[self.num_rotation_params:]
        cols = self._apply_embedding_rotation_cols_z(rot, cols, inverse=True)
        cols, log_det = self._inverse_cols_z(child, cols, log_det)
        if self.euclidean_to_sphere_as_first:
            x0, x1, log_det = manifold.zsphere2_to_plane_cols(cols[0], cols[1],
                                                              log_det)
            cols = (x0, x1)
        return cols, log_det

    def _forward_cols_z(self, child_slab, cols, log_det):
        raise NotImplementedError

    def _inverse_cols_z(self, child_slab, cols, log_det):
        raise NotImplementedError

    # -- coordinate bookkeeping ---------------------------------------------
    @property
    def embedded_dim(self):
        return self.dimension + 1

    def embedding_conditional_return(self, x):
        if x.shape[1] == self.dimension:
            x = manifold.spherical_to_eucl(x)
        return x

    def default_params(self, rng=None):
        rng = rng or np.random.default_rng(0)
        parts = [rng.standard_normal(self.num_rotation_params)]
        parts.append(self._default_params(rng))
        return np.concatenate(parts)

    def _default_params(self, rng):
        return rng.standard_normal(self.num_params - self.num_rotation_params)
