"""Avatar deformation pipeline: tracked mesh <-> SMPL-X poses (port of
mpmavatar_tpu/avatar/pipeline.py).

The reference's Trainer.load_smplx: invert the first tracked frame to the
canonical pose with KNN-transferred (or given) skinning weights, then
forward-LBS the canonical mesh to every pose of a sequence, all poses in
one batched call.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import lbs
from .smplx import SMPLXModel, smplx_forward


def deform_tracked_to_poses(model: SMPLXModel,
                            first_frame_verts: torch.Tensor,
                            first_params: Dict,
                            pose_params: Dict,
                            lbs_w: Optional[torch.Tensor] = None,
                            k: int = 10):
    """Returns (deformed_verts (B, V, 3), smplx_out_poses, lbs_w).

    first_frame_verts: tracked avatar vertices at the reference frame;
    first_params / pose_params: SMPL-X parameter dicts of tensors on the
    model's device (pose_params batched with leading B)."""
    out_first = smplx_forward(model, first_params)
    trans0 = first_params.get("trans")
    scale0 = first_params.get("scale")
    t_verts, _, w = lbs.transform_to_t_pose(
        first_frame_verts, out_first.vertices[0], out_first.transform_mat[0],
        lbs_weights_packed=model.lbs_weights, lbs_w=lbs_w,
        global_transl=None if trans0 is None else trans0[0],
        scale=None if scale0 is None else scale0.reshape(-1)[0],
        k=k)

    out_poses = smplx_forward(model, pose_params)
    b = out_poses.transform_mat.shape[0]
    transp = pose_params.get("trans")
    scalep = pose_params.get("scale")
    trs = (transp if transp is not None
           else torch.zeros((b, 3), dtype=t_verts.dtype,
                            device=t_verts.device))
    scs = (torch.as_tensor(scalep, dtype=t_verts.dtype).reshape(-1).expand(b)
           if scalep is not None
           else torch.ones((b,), dtype=t_verts.dtype, device=t_verts.device))
    deformed, _ = lbs.transform_to_pose(
        t_verts, w, out_poses.transform_mat, global_transl=trs[:, None, :],
        scale=scs[:, None, None])
    return deformed, out_poses, w


def frame_velocities(seq: torch.Tensor, fps: float = 25.0) -> torch.Tensor:
    """(T, N, 3) positions -> (T-1, N, 3) velocities."""
    return (seq[1:] - seq[:-1]) * fps
