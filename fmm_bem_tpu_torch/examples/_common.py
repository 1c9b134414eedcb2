"""What the three BEM example programs share: the device and dtype
flags, and the relaxed-schedule tiers."""

from fmm_bem_tpu_torch import resolve_device
from fmm_bem_tpu_torch.config import default_p_tiers


def add_device_flags(ap):
    ap.add_argument("-dtype", default=None,
                    help="default: float32 on the GPU (the device "
                    "solver's native precision), float64 on the CPU")
    ap.add_argument("-cpu", action="store_true",
                    help="run on the host instead of the GPU")
    ap.add_argument("-host_solver", action="store_true",
                    help="force the host GMRES loop (default: the "
                    "device-resident tiered solver on the GPU)")


def device_and_dtype(args):
    """The run's ``torch.device`` (CUDA unless ``-cpu``; no fallback)
    and its dtype name (``-dtype``, else f32 on the GPU, f64 on the
    CPU)."""
    device = resolve_device("cpu" if args.cpu else "cuda")
    if args.dtype is None:
        args.dtype = "float64" if device.type == "cpu" else "float32"
    return device, args.dtype


def prefer_device(args, device):
    """``solve_plan``'s routing as the reference programs route: the
    device-resident solver on the GPU, the host loop on the CPU or with
    ``-host_solver``."""
    return False if args.host_solver or device.type == "cpu" else None


def tiers(args, max_p):
    """``-p_tiers``: 'auto' = default_p_tiers(max_p), 'none' = the
    continuous schedule, else a comma-separated list; none at fixed p."""
    if args.fixed_p or args.p_tiers == "none":
        return None
    if args.p_tiers == "auto":
        return default_p_tiers(max_p)
    return tuple(int(t) for t in args.p_tiers.split(","))
