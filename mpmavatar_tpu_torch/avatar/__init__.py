"""The SMPL-X avatar (port of mpmavatar_tpu/avatar): LBS, the body model,
the VPoser decoder, hand-region subdivision and the pose pipeline that
re-poses a tracked garment."""

from . import lbs  # noqa: F401
from .pipeline import deform_tracked_to_poses, frame_velocities  # noqa: F401
from .smplx import (SMPLXModel, SMPLXOutput, load_smplx_npz,  # noqa: F401
                    make_test_rig, smplx_forward)
