"""pptoas (port) — wideband and narrowband TOAs from folded archives.

    python -m pulseportraiture_tpu_torch.cli.pptoas -d epochs -m PSR.spl \
        -o PSR.tim [--fit_dt4] [--fit_scat [--fit_alpha] [--no_logscat]] \
        [--nu_ref MHz] [--nu_tau MHz] [--one_DM] [--princeton] \
        [--narrowband | --psrchive [--algorithm PGS]] [--showplot] \
        [--saveplot PREFIX] [--device cuda | --device cpu [--x64]]

Runs the (phi, DM) fit, with --fit_dt4 also GM, with --fit_scat the
scattering fit; with --narrowband per-channel FFTFIT TOAs, with
--psrchive per-channel TOAs by a pat-style estimator.  All on the chosen
device: "cuda" (the default) needs a card and stops with an error
without one.  The fits run in float32, or with --x64 in float64 (the JAX
tools' parity mode), which the card's kernels do not take: --x64 needs
--device cpu and stops at argument parsing without it.  The template is
a .gmodel, a .spl or a FITS archive.
--showplot/--saveplot draw the first fitted subint of each archive
(GetTOAs.show_fit; matplotlib).  The
princeton output path of the reference calls an undefined method
(pptoas.py:1599-1601); here it writes through io.tim.write_princeton_TOA.
Reference CLI: pptoas.py:1422-1629.
"""

from __future__ import annotations

import argparse
import sys

from pulseportraiture_tpu_torch.cli import (add_common_args, fit_dtype,
                                         parse_common_args)


def build_parser():
    p = argparse.ArgumentParser(
        prog="pptoas",
        description="Measure wideband TOAs+DMs from archives against a "
                    "portrait template (PyTorch/CUDA port).")
    p.add_argument("-d", "--datafiles", required=True,
                   help="archive file, or metafile listing archives")
    p.add_argument("-m", "--modelfile", required=True,
                   help=".gmodel, .spl, or FITS-template model file")
    p.add_argument("-o", "--outfile", default=None,
                   help="output .tim file (default: stdout)")
    p.add_argument("-T", "--tscrunch", action="store_true",
                   help="time-scrunch archives before fitting")
    p.add_argument("--narrowband", action="store_true",
                   help="measure per-channel narrowband TOAs instead of "
                        "wideband TOAs")
    p.add_argument("--psrchive", action="store_true",
                   help="measure narrowband TOAs in the style of PSRCHIVE's "
                        "pat/ArrivalTime; pat-style tempo2 lines go to "
                        "--outfile/stdout")
    p.add_argument("--algorithm", default="PGS",
                   choices=("PGS", "FDM", "SIS", "PIS", "GIS", "COF"),
                   help="ArrivalTime shift estimator for --psrchive "
                        "(default PGS, the reference's choice)")
    p.add_argument("--nu_ref", type=float, default=None,
                   help="output reference frequency [MHz] (default: the "
                        "zero-covariance frequency)")
    p.add_argument("--DM", dest="DM0", type=float, default=None,
                   help="override header DM [pc cm^-3]")
    p.add_argument("--no_bary", action="store_true",
                   help="do not Doppler-correct DM to the barycenter")
    p.add_argument("--one_DM", action="store_true",
                   help="rewrite TOA DMs to the per-archive mean DM")
    p.add_argument("--fix_DM", action="store_true",
                   help="do not fit for DM")
    p.add_argument("--fit_dt4", action="store_true",
                   help="fit for GM (the nu^-4 delay); TOAs carry gm and "
                        "gm_err flags")
    p.add_argument("--fit_scat", action="store_true",
                   help="fit for scattering timescale")
    p.add_argument("--no_logscat", action="store_true",
                   help="fit tau linearly instead of log10(tau)")
    p.add_argument("--scat_guess", default=None,
                   help="tau[s],freq[MHz],index initial guess, "
                        "comma-separated")
    p.add_argument("--nu_tau", type=float, default=None,
                   help="output reference frequency for the scattering "
                        "timescale [MHz]")
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
    p.add_argument("--princeton", action="store_true",
                   help="write princeton-format TOAs instead of IPTA")
    p.add_argument("--showplot", action="store_true",
                   help="show the residual plot of the first fitted "
                        "subint per archive")
    p.add_argument("--saveplot", default=None,
                   help="save residual plots with this filename prefix")
    p.add_argument("--quiet", action="store_true")
    return add_common_args(p)


def main(argv=None):
    args = parse_common_args(build_parser(), argv)
    from pulseportraiture_tpu_torch.io.tim import (write_princeton_TOA,
                                                   write_TOAs)
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs

    scat_guess = None
    if args.scat_guess:
        vals = [float(v) for v in args.scat_guess.split(",")]
        if len(vals) != 3:
            sys.exit("--scat_guess needs tau,freq,index")
        scat_guess = tuple(vals)
    nu_refs = None
    if args.nu_ref is not None or args.nu_tau is not None:
        base = args.nu_ref
        nu_refs = (base, base,
                   args.nu_tau if args.nu_tau is not None else base)
    addtnl = {}
    if args.flags:
        for kv in args.flags.split(","):
            k, _, v = kv.partition("=")
            addtnl[k] = v
    gt = GetTOAs(args.datafiles, args.modelfile, device=args.device,
                 dtype=fit_dtype(args),
                 quiet=args.quiet)
    if args.psrchive:
        # pat-style lines; the wideband .tim machinery does not apply
        gt.get_psrchive_TOAs(tscrunch=args.tscrunch,
                             algorithm=args.algorithm)
        out = open(args.outfile, "a") if args.outfile else sys.stdout
        try:
            for lines in gt.psrchive_toas:
                for line in lines:
                    print(line, file=out)
        finally:
            if args.outfile:
                out.close()
        return 0
    if args.narrowband:
        gt.get_narrowband_TOAs(tscrunch=args.tscrunch,
                               fit_scat=args.fit_scat,
                               log10_tau=not args.no_logscat,
                               scat_guess=scat_guess,
                               print_phase=args.print_phase,
                               print_flux=args.print_flux,
                               print_parangle=args.print_parangle,
                               addtnl_toa_flags=addtnl)
    else:
        gt.get_TOAs(tscrunch=args.tscrunch, nu_refs=nu_refs, DM0=args.DM0,
                    bary=not args.no_bary, fit_DM=not args.fix_DM,
                    fit_GM=args.fit_dt4, fit_scat=args.fit_scat,
                    log10_tau=not args.no_logscat, scat_guess=scat_guess,
                    fix_alpha=args.fix_alpha, print_phase=args.print_phase,
                    print_flux=args.print_flux,
                    print_parangle=args.print_parangle,
                    addtnl_toa_flags=addtnl)

    if (args.showplot or args.saveplot) and not args.narrowband:
        for iarch, df in enumerate(gt.order):
            if not len(gt.ok_isubs[iarch]):
                continue
            isub = gt.ok_isubs[iarch][0]
            sf = f"{args.saveplot}_{iarch}_{isub}.png" \
                if args.saveplot else False
            gt.show_fit(datafile=df, isub=isub, show=args.showplot,
                        savefig=sf)

    if args.one_DM:
        # each TOA's DM becomes its archive's DeltaDM_mean + DM0
        # (pptoas.py:1603-1615)
        by_arch = {df: (gt.DeltaDM_means[i] + gt.DM0s[i], gt.DeltaDM_errs[i])
                   for i, df in enumerate(gt.order)}
        for toa in gt.TOA_list:
            if toa.archive in by_arch:
                toa.DM, toa.DM_error = by_arch[toa.archive]

    if args.princeton:
        for toa in gt.TOA_list:
            write_princeton_TOA(
                toa.MJD.intday(), toa.MJD.fracday(), toa.TOA_error,
                toa.frequency, toa.DM if toa.DM is not None else 0.0,
                obs=toa.telescope_code, outfile=args.outfile)
    else:
        write_TOAs(gt.TOA_list, SNR_cutoff=args.snr_cut,
                   outfile=args.outfile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
