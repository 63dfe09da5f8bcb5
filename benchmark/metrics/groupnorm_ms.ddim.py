"""Device ms a DDIM step under the span around the program's `group_norm`
(diffusion/nnops.py, and where unet3d.py, attention.py and vae.py bind
it), backward kernels counted with the forward op whose autograd node
they run."""

MOVES = "ddim_step_ms"
SPANS = [(f"guidedvd3dgs_tpu_torch.diffusion.{m}", "group_norm", "groupnorm")
         for m in ("nnops", "attention", "unet3d", "vae")]


def read(view):
    s = view.label_s.get("groupnorm")
    return None if not s else s / view.steps * 1e3
