"""ViewCrafter checkpoint -> the port's parameter dicts.

Counterpart of `guidedvd3dgs_tpu/diffusion/convert.py`. The diffusion
modules read torch names and layouts directly, so loading is a split of the
state dict by sub-model prefix plus the checkpoint's renames:

  * "framestride_embed" -> "fps_embedding" (reference
    utils_vc/diffusion_utils.py:84-109);
  * Lightning's "state_dict" nesting and deepspeed's "module" nesting;
  * the open_clip towers' own prefixes ("model." of the text embedder,
    "model.visual." of the image embedder), which `clip.py` reads without
    (the reference's loader keeps them, so its CLI hands the towers names
    they do not read; ROADMAP queue 3).
"""

from __future__ import annotations

from typing import Dict

import torch

SUBMODEL_PREFIXES = {
    "unet": "model.diffusion_model.",
    "vae": "first_stage_model.",
    "clip_text": "cond_stage_model.",
    "clip_image": "embedder.",
    "resampler": "image_proj_model.",
}
# inside a sub-model: the open_clip model of each CLIP embedder
CLIP_PREFIXES = {"clip_text": "model.", "clip_image": "model.visual."}


def load_viewcrafter_checkpoint(path: str, device="cpu", dtype=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The checkpoint split into {unet, vae, clip_text, clip_image,
    resampler, buffers} dicts of tensors on `device`, named as the port's
    modules read them; floating tensors of the five sub-models are cast to
    `dtype` when given. `buffers` holds every other entry (schedule arrays
    such as scale_arr)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    if isinstance(sd.get("module"), dict):  # deepspeed layout
        sd = {k.replace("module.", "", 1): v for k, v in sd["module"].items()}
    split: Dict[str, Dict[str, torch.Tensor]] = {name: {} for name in SUBMODEL_PREFIXES}
    buffers: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        k = k.replace("framestride_embed", "fps_embedding")
        v = torch.as_tensor(v)
        for name, prefix in SUBMODEL_PREFIXES.items():
            if k.startswith(prefix):
                if dtype is not None and v.is_floating_point():
                    v = v.to(dtype)
                k = k[len(prefix):]
                inner = CLIP_PREFIXES.get(name, "")
                split[name][k[len(inner):] if k.startswith(inner) else k] = v.to(device)
                break
        else:
            buffers[k] = v.to(device)
    split["buffers"] = buffers
    return split
