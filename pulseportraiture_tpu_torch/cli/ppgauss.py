"""ppgauss (port) — build an evolving Gaussian-component portrait model.

    python -m pulseportraiture_tpu_torch.cli.ppgauss -d aligned.fits \
        [-o model.gmodel] [--ngauss 2] [--niter 1] [--device cuda|cpu]

The interactive GaussianSelector is replaced by the automatic bootstrap
(--ngauss components, as in the JAX package); -I resumes from a .gmodel.
The fit computes in float64 on the chosen device ("cuda", the default,
needs a card).  Reference CLI: ppgauss.py:658-800.
"""

from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="ppgauss",
        description="Fit an evolving Gaussian-component model to an "
                    "averaged portrait (PyTorch/CUDA port).")
    p.add_argument("-d", "--datafile", required=True,
                   help="archive (or metafile) to model")
    p.add_argument("-I", "--initmodel", default=None,
                   help=".gmodel to resume/improve from")
    p.add_argument("-o", "--outfile", default=None,
                   help="output .gmodel file (default: <datafile>.gmodel)")
    p.add_argument("-j", "--joinfile", default=None,
                   help="join-parameter file for metafile inputs")
    p.add_argument("-m", "--model_name", default=None)
    p.add_argument("-e", "--errfile", action="store_true",
                   help="also write parameter uncertainties to "
                        "<outfile>.errs")
    p.add_argument("--nu_ref", type=float, default=None,
                   help="model reference frequency [MHz]")
    p.add_argument("--bw", type=float, default=None,
                   help="reference-profile bandwidth [MHz] around nu_ref")
    p.add_argument("--tau", type=float, default=0.0,
                   help="initial scattering timescale [sec]")
    p.add_argument("--fixloc", action="store_true",
                   help="freeze component locations across frequency")
    p.add_argument("--fixwid", action="store_true",
                   help="freeze component widths across frequency")
    p.add_argument("--fixamp", action="store_true",
                   help="freeze component amplitudes across frequency")
    p.add_argument("--fitscat", action="store_true",
                   help="fit the scattering timescale")
    p.add_argument("--fitalpha", action="store_true",
                   help="fit the scattering index")
    p.add_argument("--fgauss", dest="fiducial_gaussian",
                   action="store_true",
                   help="freeze the first component's location evolution")
    p.add_argument("--mcode", default=None,
                   help="evolution model code digits, e.g. 000 or 111")
    p.add_argument("--ngauss", type=int, default=1,
                   help="number of Gaussian components (automatic fit)")
    p.add_argument("--niter", type=int, default=0,
                   help="alignment refit iterations")
    p.add_argument("--norm", default=None,
                   choices=["mean", "max", "prof", "rms", "abs"],
                   help="normalize the portrait before fitting")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device for the fit (default: cuda)")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from pulseportraiture_tpu_torch.config import DEFAULT_MODEL_CODE
    from pulseportraiture_tpu_torch.portrait import DataPortrait

    dp = DataPortrait(args.datafile, joinfile=args.joinfile,
                      quiet=args.quiet, device=args.device)
    if args.norm:
        dp.normalize_portrait(args.norm)
    # --tau seconds -> bins, as the reference (ppgauss.py:793)
    tau_bins = args.tau * dp.nbin / dp.Ps[0] if args.tau else 0.0
    dp.make_gaussian_model(
        modelfile=args.initmodel, ref_prof=(args.nu_ref, args.bw),
        fixloc=args.fixloc, fixwid=args.fixwid, fixamp=args.fixamp,
        fixscat=not args.fitscat, fixalpha=not args.fitalpha,
        fiducial_gaussian=args.fiducial_gaussian,
        ngauss=args.ngauss, niter=args.niter,
        outfile=args.outfile, writeerrfile=args.errfile,
        model_name=args.model_name, nu_ref=args.nu_ref,
        model_code=args.mcode or DEFAULT_MODEL_CODE,
        tau=tau_bins, quiet=args.quiet)
    return 0


if __name__ == "__main__":
    sys.exit(main())
