"""Random-LTI codegen sweep, PyTorch/CUDA port (capability parity with
reference: examples/codegen_random.cpp, generalized): generate deployment
projects for random stabilizable plants over a sweep of (nx, nu, N) shapes
-- the shape stress test for both the precompute and the emitted solver.

The port's counterpart of ``examples/codegen_random.py``, with its
arguments; one seed gives one plant in both packages, and the emitted
projects are byte for byte the JAX twin's. Host code only.

Run: python examples/torch_codegen_random.py [--out-root DIR]
     (default DIR: tinympc_random under $TMPDIR)
"""

import argparse
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

from accelerated_tinympc_tpu_torch.api import tiny_codegen
from accelerated_tinympc_tpu_torch.models import random_lti_problem


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-root", default=str(
        pathlib.Path(tempfile.gettempdir()) / "tinympc_random"))
    ap.add_argument("--shapes", default="2x2x3,4x2x8,12x4x10,16x8x20",
                    help="comma-separated nx x nu x N")
    args = ap.parse_args()

    for spec in args.shapes.split(","):
        nx, nu, N = (int(v) for v in spec.split("x"))
        problem, rho = random_lti_problem(seed=nx * 100 + nu, nx=nx, nu=nu,
                                          horizon=N, device="cpu")
        out = tiny_codegen(
            problem.A.numpy(), problem.B.numpy(),
            problem.Q.numpy(), problem.R.numpy(),
            rho=rho, horizon=N,
            output_dir=pathlib.Path(args.out_root) / f"plant_{spec}",
            u_min=problem.u_min[0].numpy(),
            u_max=problem.u_max[0].numpy(),
            gen_wrapper=False,
        )
        print(f"nx={nx} nu={nu} N={N} -> {out}")


if __name__ == "__main__":
    main()
