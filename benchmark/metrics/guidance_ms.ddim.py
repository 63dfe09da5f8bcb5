"""Device ms a guided DDIM step under the spans around the guided
sampler's `per_frame_guidance_grads` (the decode gradients through the
VAE) and `pair_vjp` (the branches' VJPs), backward kernels included."""

MOVES = "ddim_step_ms"
SPANS = [("guidedvd3dgs_tpu_torch.diffusion.samplers.ddim_guidance", fn, "guidance")
         for fn in ("per_frame_guidance_grads", "pair_vjp")]


def read(view):
    s = view.label_s.get("guidance")
    return None if not s else s / view.steps * 1e3
