"""ppalign (port) — align and average archives into a template portrait.

    python -m pulseportraiture_tpu_torch.cli.ppalign -d A.fits B.fits \
        [-I init.fits | -g 0.05] [-T] [--niter 1] [-o aligned.fits] \
        [--device cuda|cpu]

The initial template: -g a constant Gaussian portrait of that FWHM, -I an
archive (a one-channel one is spread to a constant portrait of the data's
profile), or by default the header-aligned average of the inputs.  The
fits run in float32 on the card ("cuda", the default) or float64 on the
CPU; -s writes a smoothed copy beside the average.  Reference CLI:
ppalign.py:245-380.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile


def build_parser():
    p = argparse.ArgumentParser(
        prog="ppalign",
        description="Iteratively align and average archives "
                    "(PyTorch/CUDA port).")
    p.add_argument("-M", "--metafile", default=None,
                   help="metafile listing archives to align")
    p.add_argument("-d", "--datafiles", nargs="*", default=None,
                   help="archive files to align")
    p.add_argument("-I", "--init", default=None,
                   help="initial-template archive "
                        "(default: header-aligned average of the inputs)")
    p.add_argument("-g", "--width", type=float, default=None,
                   help="align to a single constant Gaussian component of "
                        "this FWHM (in phase) instead of -I")
    p.add_argument("-o", "--outfile", default="aligned.fits",
                   help="output averaged archive")
    p.add_argument("-T", "--tscrunch", action="store_true",
                   help="time-scrunch archives before aligning")
    p.add_argument("-D", "--phase_only", action="store_true",
                   help="fit phase only (no DM)")
    p.add_argument("-p", "--stokes", action="store_true",
                   help="average all four Stokes polarizations "
                        "(alignment still uses total intensity)")
    p.add_argument("-C", "--snr_cutoff", type=float, default=0.0,
                   help="skip subints below this S/N")
    p.add_argument("-N", "--norm", default=None,
                   choices=["mean", "max", "prof", "rms", "abs"],
                   help="normalize the final average")
    p.add_argument("-s", "--smooth", action="store_true",
                   help="also write a wavelet-smoothed copy "
                        "(<outfile>.sm)")
    p.add_argument("-r", "--rot", type=float, default=0.0,
                   help="rotate the final average by this phase")
    p.add_argument("--place", type=float, default=None,
                   help="place the profile peak at this phase")
    p.add_argument("--niter", type=int, default=1,
                   help="alignment iterations")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device for the fits (default: cuda)")
    p.add_argument("--quiet", action="store_true")
    return p


def _tmp_archive():
    fd, path = tempfile.mkstemp(suffix=".tmp.fits", prefix="ppalign.")
    os.close(fd)
    return path


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.metafile and not args.datafiles:
        sys.exit("provide -M metafile or -d datafiles")
    from pulseportraiture_tpu_torch.io.psrfits import read_psrfits
    from pulseportraiture_tpu_torch.pipelines.align import (
        align_archives, average_archives, psrsmooth_archive)
    from pulseportraiture_tpu_torch.pipelines.toas import _resolve_datafiles
    from pulseportraiture_tpu_torch.sim.fake import make_constant_portrait

    files = args.datafiles or _resolve_datafiles(args.metafile)
    # the initial template, as the reference's __main__
    # (ppalign.py:342-368)
    init, tmp_init = args.init, None
    if args.width is not None:
        from pulseportraiture_tpu_torch.ops.gaussian import gaussian_profile
        tmp_init = init = _tmp_archive()
        nbin = read_psrfits(files[0]).data.shape[-1]
        make_constant_portrait(files[0], tmp_init,
                               profile=gaussian_profile(nbin, 0.5,
                                                        args.width),
                               DM=0.0, dmc=False, quiet=True)
    elif init is None:
        tmp_init = init = _tmp_archive()
        average_archives(files, tmp_init, tscrunch=True,
                         pscrunch=not args.stokes, quiet=True)
    elif read_psrfits(init).data.shape[2] == 1:
        tmp_init = init = _tmp_archive()
        make_constant_portrait(files[0], tmp_init, profile=None, DM=0.0,
                               dmc=False, quiet=True)
    try:
        align_archives(
            metafile=args.metafile, datafiles=args.datafiles,
            initial_guess=init, tscrunch=args.tscrunch,
            pscrunch=not args.stokes, outfile=args.outfile, norm=args.norm,
            fit_dm=not args.phase_only, niter=args.niter,
            SNR_cutoff=args.snr_cutoff, place=args.place,
            rot_phase=args.rot, quiet=args.quiet, device=args.device)
        if args.smooth:
            psrsmooth_archive(args.outfile, quiet=args.quiet,
                              device=args.device)
    finally:
        if tmp_init is not None and os.path.exists(tmp_init):
            os.remove(tmp_init)
    return 0


if __name__ == "__main__":
    sys.exit(main())
