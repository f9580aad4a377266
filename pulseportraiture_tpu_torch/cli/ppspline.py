"""ppspline (port) — build a PCA + B-spline interpolation portrait model.

    python -m pulseportraiture_tpu_torch.cli.ppspline -d aligned.fits \
        [-o model.spl] [-N prof] [-s] [-n 10] [--device cuda|cpu]

The builder computes in float64 on the chosen device ("cuda", the
default, needs a card).  --plots shows, --saveplots PREFIX writes
PREFIX_eig.png and PREFIX_spl.png: the eigenprofiles and the spline
curve's projections (matplotlib).  Reference CLI: ppspline.py:279-383.
"""

from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="ppspline",
        description="Build a PCA+spline model from an averaged portrait "
                    "(PyTorch/CUDA port).")
    p.add_argument("-d", "--datafile", required=True,
                   help="archive (or metafile) to model")
    p.add_argument("-o", "--outfile", default=None,
                   help="output .spl model (default: <datafile>.spl)")
    p.add_argument("-l", "--model_name", default=None)
    p.add_argument("-a", "--archive", default=None,
                   help="also write the model reconstruction "
                        "as an archive to this path")
    p.add_argument("-N", "--norm", default="prof",
                   choices=["None", "mean", "max", "prof", "rms", "abs"],
                   help="portrait normalization method (default: prof)")
    p.add_argument("-s", "--smooth", action="store_true",
                   help="wavelet-smooth eigenvectors and mean profile")
    p.add_argument("-n", "--ncomp", type=int, default=10,
                   help="max number of PCA components")
    p.add_argument("-S", "--snr_cutoff", type=float, default=150.0,
                   help="Fourier S/N cutoff for significant eigenvectors")
    p.add_argument("-T", "--rchi2_tol", type=float, default=0.1,
                   help="smoothing red-chi2 tolerance")
    p.add_argument("-k", type=int, default=3, help="spline degree")
    p.add_argument("-f", "--sfac", type=float, default=1.0,
                   help="spline smoothing factor multiplier")
    p.add_argument("-t", "--max_nbreak", type=int, default=None,
                   help="max number of spline breakpoints")
    p.add_argument("--plots", action="store_true",
                   help="show eigenprofile and spline-projection plots")
    p.add_argument("--saveplots", default=None,
                   help="save the plots with this filename prefix")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device for the builder (default: cuda)")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from pulseportraiture_tpu_torch.portrait import DataPortrait

    dp = DataPortrait(args.datafile, quiet=args.quiet, device=args.device)
    if args.norm != "None":
        dp.normalize_portrait(args.norm)
    dp.make_spline_model(
        max_ncomp=args.ncomp, smooth=args.smooth,
        snr_cutoff=args.snr_cutoff, rchi2_tol=args.rchi2_tol,
        k=args.k, sfac=args.sfac, max_nbreak=args.max_nbreak,
        model_name=args.model_name, quiet=args.quiet)
    dp.write_model(args.outfile or (args.datafile + ".spl"),
                   quiet=args.quiet)
    if args.plots or args.saveplots:
        pre = args.saveplots
        dp.show_eigenprofiles(savefig=f"{pre}_eig.png" if pre else False,
                              show=args.plots)
        dp.show_spline_curve_projections(
            savefig=f"{pre}_spl.png" if pre else False, show=args.plots)
    if args.archive:
        dp.write_model_archive(args.archive, quiet=args.quiet)
    return 0


if __name__ == "__main__":
    sys.exit(main())
