"""Mesh preprocessing for stage-1 tracking (host numpy and scipy):
copies of mpmavatar_tpu/preprocess, which the port may not import."""

from .garment_split import save_split, split_cloth_human  # noqa: F401
from .lbs_inpainting import transfer_and_inpaint  # noqa: F401
