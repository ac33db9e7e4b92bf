"""Host-side numpy MANO forward (rotmat API) for the data pipeline
(counterpart of ``dir_tpu/data/mano_np.py``).

Synthesizes the ground-truth verts/joints of each sample from its stored
MANO parameters in numpy (fp64 inside, fp32 out): no device round-trip in
the input pipeline. Matches the data-side API
(``mano/layer.py:mano_forward_rotmat``).
"""

from __future__ import annotations

import numpy as np

from dir_tpu_torch.mano.assets import (JOINT_REORDER, MANO_PARENTS,
                                       ManoModel)


class NumpyMano:
    """Vectorized numpy MANO (batch-first), built from a ManoModel."""

    def __init__(self, model: ManoModel):
        def arr(t, dtype):
            return np.asarray(t.detach().cpu().numpy(), dtype)

        self.v_template = arr(model.v_template, np.float64)
        self.shapedirs = arr(model.shapedirs, np.float64)
        self.posedirs = arr(model.posedirs, np.float64)
        self.j_regressor = arr(model.j_regressor, np.float64)
        self.weights = arr(model.weights, np.float64)
        self.hands_components = arr(model.hands_components, np.float64)
        self.hands_mean = arr(model.hands_mean, np.float64)
        self.faces = arr(model.faces, np.int64)
        self.tips = arr(model.tips, np.int64)

    @staticmethod
    def rodrigues(axis: np.ndarray) -> np.ndarray:
        """(N, 3) -> (N, 3, 3), classic formula with +1e-8 on the norm."""
        angle = np.linalg.norm(axis, axis=1, keepdims=True) + 1e-8
        ax = axis / angle
        sin = np.sin(angle)[..., None]
        cos = np.cos(angle)[..., None]
        z = np.zeros_like(ax[:, 0])
        k = np.stack([z, -ax[:, 2], ax[:, 1],
                      ax[:, 2], z, -ax[:, 0],
                      -ax[:, 1], ax[:, 0], z], 1).reshape(-1, 3, 3)
        kk = ax[:, :, None] * ax[:, None, :] - np.eye(3)
        return np.eye(3) + sin * k + (1.0 - cos) * kk

    def pca_to_rotmats(self, pca: np.ndarray) -> np.ndarray:
        axis = pca @ self.hands_components[: pca.shape[1]] + self.hands_mean
        return self.rodrigues(axis.reshape(-1, 3)).reshape(-1, 15, 3, 3)

    def axis_to_pca(self, axis: np.ndarray) -> np.ndarray:
        """(B, 45) axis-angle -> PCA coefficients."""
        inv = np.linalg.inv(self.hands_components)
        return (axis - self.hands_mean) @ inv

    # new_skel knuckle remap: joints 5/9/13/17 (index/middle/ring/pinky
    # MCP) replaced by surface-vertex midpoints; an option of the
    # data-side MANO that DIR does not use.
    NEW_SKEL = ((5, 63, 144), (9, 271, 220), (13, 148, 290), (17, 770, 83))

    def __call__(self, root_rot: np.ndarray, pose: np.ndarray,
                 shape: np.ndarray, trans: np.ndarray | None = None,
                 scale: np.ndarray | None = None,
                 center_idx: int | None = None, use_pca: bool = True,
                 new_skel: bool = False):
        """root_rot (B,3,3); pose (B,ncomps)|(B,15,3,3); shape (B,10)."""
        b = root_rot.shape[0]
        local = self.pca_to_rotmats(pose) if use_pca else pose

        v_shaped = (np.einsum("vcs,bs->bvc", self.shapedirs, shape)
                    + self.v_template)
        j_rest = np.einsum("jv,bvc->bjc", self.j_regressor, v_shaped)
        pose_map = (local - np.eye(3)).reshape(b, 135)
        v_posed = v_shaped + np.einsum("vcp,bp->bvc", self.posedirs, pose_map)

        g = np.zeros((b, 16, 4, 4))
        g[:, :, 3, 3] = 1.0
        g[:, 0, :3, :3] = root_rot
        g[:, 0, :3, 3] = j_rest[:, 0]
        for i in range(1, 16):
            p = MANO_PARENTS[i]
            rel = np.zeros((b, 4, 4))
            rel[:, 3, 3] = 1.0
            rel[:, :3, :3] = local[:, i - 1]
            rel[:, :3, 3] = j_rest[:, i] - j_rest[:, p]
            g[:, i] = g[:, p] @ rel
        joints16 = g[:, :, :3, 3].copy()

        # inverse bind: subtract A @ (j, 0) from the translation column
        # (its 4th component is 0 since the bottom row is (0,0,0,1)).
        bind_t = np.einsum("bjik,bjk->bji", g[:, :, :, :3], j_rest)
        a = g.copy()
        a[:, :, :, 3] -= bind_t
        m = np.einsum("vj,bjik->bvik", self.weights, a)
        verts = (np.einsum("bvik,bvk->bvi", m[:, :, :3, :3], v_posed)
                 + m[:, :, :3, 3])

        joints = np.concatenate([joints16, verts[:, self.tips]], axis=1)
        joints = joints[:, list(JOINT_REORDER)]

        if center_idx is not None:
            c = joints[:, center_idx:center_idx + 1]
            verts = verts - c
            joints = joints - c
        if scale is not None:
            verts = verts * scale[:, None, None]
            joints = joints * scale[:, None, None]
        if trans is not None:
            verts = verts + trans[:, None, :]
            joints = joints + trans[:, None, :]
        if new_skel:
            for j, va, vb in self.NEW_SKEL:
                joints[:, j] = (verts[:, va] + verts[:, vb]) / 2
        return verts.astype(np.float32), joints.astype(np.float32)
