"""ppzap (port) — flag bad channels in an archive.

    python -m pulseportraiture_tpu_torch.cli.ppzap -d X.fits [-o out.fits] \
        [-m X.spl [--snr_threshold 8] [--rchi2_threshold 1.3]] \
        [--nstd 3] [--per_subint] [--norm] [--print_cmds] \
        [--device cuda | --device cpu [--x64]]

Without a model, clips channels by their noise levels; with one (-m),
fits TOAs on the chosen device ("cuda", the default, needs a card), in
float32 or with --x64 in float64 (the parity mode; CPU only, as in
pptoas), and flags channels by reduced chi2 and S/N.  The mask is applied and a
masked archive written (<datafile>.zap.fits by default); --print_cmds
prints paz-style commands instead.  --showplot/--saveplot FILE show or
write the histogram of the channels' reduced chi2 with the threshold
marked (model path; matplotlib).  Reference CLI: ppzap.py:98-241.
"""

from __future__ import annotations

import argparse
import sys

from pulseportraiture_tpu_torch.cli import (add_common_args, fit_dtype,
                                         parse_common_args)


def build_parser():
    p = argparse.ArgumentParser(
        prog="ppzap", description="Flag bad channels (PyTorch/CUDA port).")
    p.add_argument("-d", "--datafile", required=True,
                   help="archive to zap")
    p.add_argument("-o", "--outfile", default=None,
                   help="output masked archive "
                        "(default: <datafile>.zap.fits)")
    p.add_argument("-m", "--modelfile", default=None,
                   help="model file: use the model-based (post-fit) "
                        "zapping path")
    p.add_argument("--nstd", type=float, default=3.0,
                   help="model-free clip threshold in sigma")
    p.add_argument("--snr_threshold", type=float, default=8.0,
                   help="model path: channel S/N threshold")
    p.add_argument("--rchi2_threshold", type=float, default=1.3,
                   help="model path: per-channel red-chi2 threshold")
    p.add_argument("--per_subint", action="store_true",
                   help="zap per subint instead of the union")
    p.add_argument("--norm", action="store_true",
                   help="normalize noise levels before clipping")
    p.add_argument("--print_cmds", action="store_true",
                   help="print paz-style commands instead of writing")
    p.add_argument("--showplot", action="store_true",
                   help="model path: show the channel red-chi2 histogram")
    p.add_argument("--saveplot", default=None,
                   help="model path: save the histogram to this file")
    p.add_argument("--quiet", action="store_true")
    return add_common_args(p)


def show_rchi2_histogram(channel_red_chi2s, threshold, show=False,
                         savefig=None):
    """Histogram of the channels' reduced chi2 (get_channels_to_zap's
    channel_red_chi2s) with the threshold marked; returns the figure."""
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np
    rchi2s = np.concatenate(
        [np.asarray(r) for arch in channel_red_chi2s for r in arch]) \
        if channel_red_chi2s else np.array([])
    fig, ax = plt.subplots()
    ax.hist(rchi2s[np.isfinite(rchi2s)], bins=30, color="gray")
    ax.axvline(threshold, color="r", ls="--", label=f"threshold {threshold}")
    ax.set_xlabel("Channel reduced chi2")
    ax.legend()
    if savefig:
        fig.savefig(savefig)
    if show:
        plt.show()
    plt.close(fig)
    return fig


def main(argv=None):
    args = parse_common_args(build_parser(), argv)
    outfile = args.outfile or (args.datafile + ".zap.fits")

    if args.modelfile:
        from pulseportraiture_tpu_torch.io.archive import (
            load_data, unload_new_archive)
        from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs
        from pulseportraiture_tpu_torch.pipelines.zap import \
            zap_channels_from_fit
        gt = GetTOAs([args.datafile], args.modelfile, device=args.device,
                     dtype=fit_dtype(args), quiet=args.quiet)
        gt.get_TOAs(quiet=args.quiet)
        zaps = zap_channels_from_fit(
            gt, SNR_threshold=args.snr_threshold,
            rchi2_threshold=args.rchi2_threshold)
        if args.showplot or args.saveplot:
            show_rchi2_histogram(gt.channel_red_chi2s, args.rchi2_threshold,
                                 show=args.showplot, savefig=args.saveplot)
        for iarch, arch_zaps in enumerate(zaps):
            for ii, zap in enumerate(arch_zaps):
                isub = gt.ok_isubs[iarch][ii]
                if args.print_cmds:
                    for chan in zap:
                        print(f"paz -m -z {chan} -w {isub} "
                              f"{gt.order[iarch]}")
                elif not args.quiet:
                    print(f"{gt.order[iarch]} subint {isub}: "
                          f"zap channels {zap}")
        if not args.print_cmds and zaps:
            # apply the mask and write the archive
            data = load_data(args.datafile, rm_baseline=False, quiet=True)
            weights = data.weights.copy()
            for ii, zap in enumerate(zaps[0]):
                isub = gt.ok_isubs[0][ii]
                if args.per_subint:
                    weights[isub, zap] = 0.0
                else:
                    weights[:, zap] = 0.0
            unload_new_archive(data.subints, data.arch, outfile,
                               DM=data.DM, dmc=int(data.dmc),
                               weights=weights, quiet=args.quiet)
            if not args.quiet:
                print(f"wrote {outfile}")
        return 0

    from pulseportraiture_tpu_torch.pipelines.zap import zap_archive
    all_zaps = zap_archive(args.datafile, outfile, nstd=args.nstd,
                           per_subint=args.per_subint, normalize=args.norm,
                           quiet=args.quiet, device=args.device)
    if args.print_cmds:
        for isub, zap in enumerate(all_zaps):
            for chan in zap:
                print(f"paz -m -z {chan} -w {isub} {args.datafile}")
    elif not args.quiet:
        print(f"wrote {outfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
