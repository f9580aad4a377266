"""Command-line tools.

Options shared by the tools that fit on a device (pptoas, ppzap) live
here, as the JAX package's ``add_common_args`` keeps its own.
"""


def add_common_args(parser):
    """--device and --x64, the JAX tools' float64 parity mode."""
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="device for the fits (default: cuda)")
    parser.add_argument("--x64", action="store_true",
                        help="fit in float64 (the CPU parity mode; needs "
                             "--device cpu)")
    return parser


def parse_common_args(parser, argv=None):
    """parser.parse_args(argv), refusing --x64 on the card: its kernels
    take float32 data only, and the tools never move to the CPU
    unasked."""
    args = parser.parse_args(argv)
    if args.x64 and args.device != "cpu":
        parser.error("--x64 (float64) runs on the CPU only: the card's "
                     "kernels take float32; add --device cpu")
    return args


def fit_dtype(args):
    """The fits' torch dtype: float64 with --x64, else float32."""
    import torch
    return torch.float64 if args.x64 else torch.float32
