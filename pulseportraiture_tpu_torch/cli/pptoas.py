"""pptoas (port) — wideband TOAs and DMs from folded archives.

    python -m pulseportraiture_tpu_torch.cli.pptoas -d epochs -m PSR.spl \
        -o PSR.tim [--fit_scat [--fit_alpha] [--no_logscat]] \
        [--device cuda|cpu]

Runs the (phi, DM) fit, or with --fit_scat the scattering fit, on the
chosen device: "cuda" (the default) needs a card and stops with an error
without one.  Reference CLI: pptoas.py:1422-1629.
"""

from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="pptoas",
        description="Measure wideband TOAs+DMs from archives against a "
                    "portrait template (PyTorch/CUDA port).")
    p.add_argument("-d", "--datafiles", required=True,
                   help="archive file, or metafile listing archives")
    p.add_argument("-m", "--modelfile", required=True,
                   help=".spl spline model or FITS-template model file")
    p.add_argument("-o", "--outfile", default=None,
                   help="output .tim file (default: stdout)")
    p.add_argument("-T", "--tscrunch", action="store_true",
                   help="time-scrunch archives before fitting")
    p.add_argument("--DM", dest="DM0", type=float, default=None,
                   help="override header DM [pc cm^-3]")
    p.add_argument("--no_bary", action="store_true",
                   help="do not Doppler-correct DM to the barycenter")
    p.add_argument("--fix_DM", action="store_true",
                   help="do not fit for DM")
    p.add_argument("--fit_scat", action="store_true",
                   help="fit for scattering timescale")
    p.add_argument("--no_logscat", action="store_true",
                   help="fit tau linearly instead of log10(tau)")
    p.add_argument("--scat_guess", default=None,
                   help="tau[s],freq[MHz],index initial guess, "
                        "comma-separated")
    p.add_argument("--nu_tau", type=float, default=None,
                   help="output reference frequency for the scattering "
                        "timescale [MHz] (not ported yet)")
    p.add_argument("--fix_alpha", action="store_true", default=True,
                   help="hold the scattering index fixed (default)")
    p.add_argument("--fit_alpha", dest="fix_alpha", action="store_false",
                   help="fit the scattering index")
    p.add_argument("--print_phase", action="store_true",
                   help="add -phs/-phs_err flags to TOA lines")
    p.add_argument("--print_flux", action="store_true",
                   help="add -flux/-flux_err flags to TOA lines")
    p.add_argument("--print_parangle", action="store_true",
                   help="add the parallactic angle to TOA lines")
    p.add_argument("--flags", default=None,
                   help="additional TOA flags: name1=val1,name2=val2,...")
    p.add_argument("--snr_cut", type=float, default=0.0,
                   help="drop TOAs below this S/N")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device for the fits (default: cuda)")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from pulseportraiture_tpu_torch.io.tim import write_TOAs
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs

    scat_guess = None
    if args.scat_guess:
        vals = [float(v) for v in args.scat_guess.split(",")]
        if len(vals) != 3:
            sys.exit("--scat_guess needs tau,freq,index")
        scat_guess = tuple(vals)
    nu_refs = None
    if args.nu_tau is not None:
        nu_refs = (None, None, args.nu_tau)
    addtnl = {}
    if args.flags:
        for kv in args.flags.split(","):
            k, _, v = kv.partition("=")
            addtnl[k] = v
    gt = GetTOAs(args.datafiles, args.modelfile, device=args.device,
                 dtype=torch.float32,
                 quiet=args.quiet)
    gt.get_TOAs(tscrunch=args.tscrunch, nu_refs=nu_refs, DM0=args.DM0,
                bary=not args.no_bary, fit_DM=not args.fix_DM,
                fit_scat=args.fit_scat, log10_tau=not args.no_logscat,
                scat_guess=scat_guess, fix_alpha=args.fix_alpha,
                print_phase=args.print_phase,
                print_flux=args.print_flux,
                print_parangle=args.print_parangle,
                addtnl_toa_flags=addtnl)
    write_TOAs(gt.TOA_list, SNR_cutoff=args.snr_cut, outfile=args.outfile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
