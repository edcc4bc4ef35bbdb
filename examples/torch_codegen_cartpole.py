"""Cartpole codegen, PyTorch/CUDA port (capability parity with reference:
examples/codegen_cartpole.cpp): generate a standalone C++ deployment project
for the upright cartpole, build it, and run the emitted MPC demo.

The port's counterpart of ``examples/codegen_cartpole.py``, with its
arguments; the emitted project is byte for byte the JAX twin's. Generation
is float64 numpy on the host and touches no GPU.

Run: python examples/torch_codegen_cartpole.py [--out DIR] [--no-build]
     (default DIR: tinympc_cartpole_project under $TMPDIR)
"""

import argparse
import pathlib
import subprocess
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import accelerated_tinympc_tpu_torch as atm
from accelerated_tinympc_tpu_torch.api import build_project, tiny_codegen
from accelerated_tinympc_tpu_torch.models import cartpole


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(pathlib.Path(tempfile.gettempdir())
                                         / "tinympc_cartpole_project"))
    ap.add_argument("--no-build", action="store_true")
    args = ap.parse_args()

    out = tiny_codegen(
        cartpole.A, cartpole.B, cartpole.Q_DIAG, cartpole.R_DIAG,
        rho=cartpole.RHO, horizon=10, output_dir=args.out,
        x_min=-5.0, x_max=5.0, u_min=-5.0, u_max=5.0,
        settings=atm.Settings(max_iter=100, check_termination=1),
        gen_wrapper=True,
    )
    print(f"generated project at {out}")
    for f in sorted(p.relative_to(out) for p in out.rglob("*") if p.is_file()):
        print(f"  {f}")

    if not args.no_build:
        binary = build_project(out)
        print(f"built {binary}; running 5 MPC ticks from x0=(0.3, 0, 0.1, 0):")
        res = subprocess.run(
            [str(binary), "0.3", "0", "0.1", "0", "5"],
            capture_output=True, text=True, check=True,
        )
        print(res.stdout)


if __name__ == "__main__":
    main()
