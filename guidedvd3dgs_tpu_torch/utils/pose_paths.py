"""The spiral and ellipse flythrough paths (and the stepfun sampler they
use), from the vendored multinerf code, under the name the reference
package's callers use."""

from guidedvd3dgs_tpu_torch.vendored.multinerf_paths import (  # noqa: F401
    generate_ellipse_path,
    generate_spiral_path,
    integrate_weights_np,
    invert_cdf_np,
    normalize,
    sample_np,
    viewmatrix,
)
