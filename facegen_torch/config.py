"""Run configurations of the port's trainer and sampler.

Fields of facegen/config.py:TrainConfig, C2FConfig and SampleConfig
(flags of ``th train.lua``, ``th train_c2f.lua`` and ``th sample.lua``),
copied rather than imported: importing facegen pulls in JAX. The configs
keep facegen's field names, so a checkpoint's stored config reads the
same in both packages.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from typing import Optional, Sequence, Tuple


def mesh_axes(mesh_shape: Sequence[int]) -> Tuple[int, int, bool]:
    """``--meshShape`` 'DP' or 'DP,MP' as (DP, MP, whether it named two
    axes): DP is positive or -1 (every rank), MP positive; 'DP' is (DP, 1,
    False). Raises ValueError for any other shape."""
    shape, flag = tuple(mesh_shape), ",".join(str(v) for v in mesh_shape)
    if len(shape) not in (1, 2):
        raise ValueError(f"--meshShape {flag}: 'DP' or 'DP,MP'")
    dp, mp = shape[0], (shape[1] if len(shape) == 2 else 1)
    if dp == 0 or dp < -1:
        raise ValueError(f"--meshShape {flag}: a positive size or -1")
    if mp < 1:
        raise ValueError(f"--meshShape {flag}: the model axis must be positive")
    return dp, mp, len(shape) == 2


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Flags of ``th train.lua`` (train.lua:16-50) and facegen's
    additions. ``trace_dir``, ``debug_nans``, ``guard_nonfinite`` and
    ``g_train_in_d_phase`` are config fields with no flag, as in facegen
    (train/loop.py and train/step.py read them). The autoencoder and
    denoiser trainers read the same flags (their own: coef_l1, coef_l2,
    ae_clamp)."""

    batch_size: int = 32          # --batchSize (even, >= 4; train.lua:56-60)
    save: str = "logs"            # --save
    save_freq: int = 30           # --saveFreq
    network: str = ""             # --network (checkpoint to resume)
    noplot: bool = False          # --noplot
    n_epoch: int = 1000           # --N_epoch (examples per epoch, -1 = all)
    g_sgd_lr: float = 0.02        # --G_SGD_lr
    g_sgd_momentum: float = 0.0   # --G_SGD_momentum
    d_sgd_lr: float = 0.02        # --D_SGD_lr
    d_sgd_momentum: float = 0.0   # --D_SGD_momentum
    g_adam_lr: float = -1.0       # --G_adam_lr (-1 = optim default 0.001)
    d_adam_lr: float = -1.0       # --D_adam_lr
    g_l1: float = 0.0             # --G_L1
    g_l2: float = 0.0             # --G_L2
    d_l1: float = 0.0             # --D_L1
    d_l2: float = 1e-4            # --D_L2
    d_iterations: int = 1         # --D_iterations
    g_iterations: int = 1         # --G_iterations
    d_max_acc: float = 1.01       # --D_maxAcc (accuracy gate threshold)
    d_clamp: float = 1.0          # --D_clamp (0 = off)
    g_clamp: float = 5.0          # --G_clamp (0 = off)
    d_optmethod: str = "adam"     # --D_optmethod: sgd|adagrad|adam
    g_optmethod: str = "adam"     # --G_optmethod
    threads: int = 8              # --threads (accepted; the port has no host workers)
    noise_dim: int = 100          # --noiseDim
    window: int = 3               # --window: non-default ids prefix viz PNGs with w{id}_
    scale: int = 32               # --scale (the GAN's nets: 16 or 32)
    seed: int = 1                 # --seed
    weights_vis_freq: int = 0     # --weightsVisFreq (activation dumps every N steps)
    grayscale: bool = False       # --grayscale
    denoise: bool = False         # --denoise (samples_denoised.png through AE1's decoder)
    aws: bool = False             # --aws (dataset dir switch, train.lua:166)
    coef_l1: float = 0.0          # --coefL1 (AE/denoiser trainers only)
    coef_l2: float = 0.0          # --coefL2
    ae_clamp: float = 1.0         # --AE_clamp
    # facegen's additions
    mesh_shape: Tuple[int, ...] = (1,)    # 'DP' or 'DP,MP' ranks of a process group (parallel/)
    compute_dtype: str = "bfloat16"       # activations dtype; params stay fp32
    reference_init: bool = True           # the reference's gaussian overwrite
    reference_g_penalty_bug: bool = True  # adversarial.lua:223: G_L2 scales both
                                          # penalty gradient terms
    dataset_dir: Optional[str] = None
    synthetic_data: bool = False
    epochs: int = -1                      # stop after N epochs (-1 = forever)
    epochs_per_compile: int = 0           # epochs per chunk with one read-back
                                          # (0 = 8 under --noplot without
                                          # weightsVisFreq, else 1)
    trace_dir: Optional[str] = None       # torch.profiler trace of epoch 1 (no flag)
    debug_nans: bool = False              # NaN debug mode, eager steps (no flag)
    noise_view: str = "nhwc"              # G's fc -> planes wiring ("nhwc"/"nchw")
    guard_nonfinite: bool = False         # skip any update whose gradients are not
                                          # finite (no flag)
    g_train_in_d_phase: bool = True       # G in train mode while it makes D's fakes;
                                          # False: eval mode (no flag)
    boundary_pad: int = 0                 # --boundaryPad: widen the G->D image
                                          # interface to P channels inside the step
                                          # (train/step.py:make_boundary_padder; 0 = off)
    # the port's own
    gpu: int = 0                          # --gpu: CUDA device index

    @property
    def channels(self) -> int:
        return 1 if self.grayscale else 3

    @property
    def img_shape(self) -> Tuple[int, int, int]:
        return (self.scale, self.scale, self.channels)

    @property
    def accs_interval(self) -> int:
        """The D accuracy gate's window: max(20, min(1000/batchSize,
        250)) batches, floored (train.lua:207, adversarial.lua:157-159)."""
        return int(math.floor(max(20.0, min(1000.0 / self.batch_size, 250.0))))

    @property
    def d_adam_lr_effective(self) -> float:
        return self.d_adam_lr if self.d_adam_lr > 0 else 1e-3

    @property
    def g_adam_lr_effective(self) -> float:
        return self.g_adam_lr if self.g_adam_lr > 0 else 1e-3

    def validate(self) -> "TrainConfig":
        if self.batch_size % 2 != 0 or self.batch_size < 4:
            raise ValueError("batch size must be a multiple of 2 and >= 4 (train.lua:56-60)")
        for which, method in (("D", self.d_optmethod), ("G", self.g_optmethod)):
            if method not in ("sgd", "adagrad", "adam"):
                raise ValueError(f"unknown {which} optimizer {method!r}")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute dtype {self.compute_dtype!r}: bfloat16 or float32")
        if self.noise_view not in ("nhwc", "nchw"):
            raise ValueError(f"unknown noise_view {self.noise_view!r}")
        # 'DP' or 'DP,MP'; train/loop.py:main checks it against the
        # process group when it makes the mesh
        mesh_axes(self.mesh_shape)
        return self


@dataclasses.dataclass(frozen=True)
class C2FConfig:
    """Flags of ``th train_c2f.lua`` (train_c2f.lua:16-46) and facegen's
    additions (facegen/config.py:159-217). Its defaults differ from the
    GAN's: D_L1 1e-7, D_L2 0; the stock optimizers have no gate."""

    save: str = "logs"
    save_freq: int = 30
    network: str = ""
    noplot: bool = False
    d_sgd_lr: float = 0.02
    g_sgd_lr: float = 0.02
    d_sgd_momentum: float = 0.0
    g_sgd_momentum: float = 0.0
    batch_size: int = 32
    n_epoch: int = 1000
    g_l1: float = 0.0
    g_l2: float = 0.0
    d_l1: float = 1e-7
    d_l2: float = 0.0
    d_iterations: int = 1
    g_iterations: int = 1
    d_clamp: float = 1.0
    g_clamp: float = 5.0
    d_optmethod: str = "adam"
    g_optmethod: str = "adam"
    threads: int = 4          # accepted; the port has no host workers
    noise_dim: int = 100      # kept for CLI parity; c2f noise is image-shaped
    window: int = 3
    coarse_size: int = 16
    fine_size: int = 32
    grayscale: bool = False
    seed: int = 1
    aws: bool = False
    # facegen's additions
    compute_dtype: str = "bfloat16"
    reference_g_penalty_bug: bool = True
    dataset_dir: Optional[str] = None
    synthetic_data: bool = False
    epochs: int = -1
    val_size: int = 500       # VAL_DATA = loadImages(0, 500) (train_c2f.lua:218)
    parzen_samples: int = 200
    mesh_shape: Tuple[int, ...] = (1,)  # 'DP' or 'DP,MP' ranks of a process group
    boundary_pad: int = 0     # --boundaryPad: widen the diff/coarse interface inside
                              # the step (train/c2f.py; 0 = off)
    # the port's own
    gpu: int = 0              # --gpu: CUDA device index

    @property
    def channels(self) -> int:
        return 1 if self.grayscale else 3

    @property
    def img_shape(self) -> Tuple[int, int, int]:
        return (self.fine_size, self.fine_size, self.channels)

    def validate(self) -> "C2FConfig":
        if self.batch_size % 2 != 0 or self.batch_size < 4:
            raise ValueError("batch size must be even and >= 4")
        for which, method in (("D", self.d_optmethod), ("G", self.g_optmethod)):
            if method not in ("sgd", "adagrad", "adam"):
                raise ValueError(f"unknown {which} optimizer {method!r}")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute dtype {self.compute_dtype!r}: bfloat16 or float32")
        mesh_axes(self.mesh_shape)  # checked against the process group by train_c2f.main
        return self


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    """scale/grayscale/noise_dim default to None, meaning "use the
    checkpoint's stored config"; explicit values are checked overrides
    (models/gan.py:restore_gan)."""

    save: str = "logs"            # --save_base (checkpoint dir)
    network: str = "adversarial"  # --G_base (checkpoint name)
    d_network: Optional[str] = None  # --D_base: D from another checkpoint
    batch_size: int = 32
    noise_dim: Optional[int] = None
    scale: Optional[int] = None
    grayscale: Optional[bool] = None
    seed: int = 1
    gpu: int = 0                  # --gpu: CUDA device index
    runs: int = 1
    neighbours: bool = False
    writeto: str = "samples"
    aws: bool = False
    dataset_dir: Optional[str] = None  # --datasetDir: store for --neighbours
    c2f: bool = False             # refine best/worst/random through a c2f pair
    c2f_network: str = "adversarial_c2f_16_to_32"  # --G_c2f32
    d_c2f_network: Optional[str] = None  # --D_c2f32: c2f D from another checkpoint
    save_c2f: str = ""            # --save_c2f32 (empty = --save_base)
    c2f_tries: int = 10           # candidate diffs per image (sample.lua:177)
    mesh_shape: Tuple[int, ...] = ()  # 'DP' or 'DP,MP' serving cards; empty = one (sample.py)
    truncation_psi: float = 1.0   # --truncationPsi: StyleGAN2's truncation (1 = none)

    @property
    def channels(self) -> int:
        return 1 if self.grayscale else 3


def _add_bool(p: argparse.ArgumentParser, name: str, help: str):
    p.add_argument(name, action="store_true", default=False, help=help)


def train_arg_parser() -> argparse.ArgumentParser:
    """facegen's trainer CLI (facegen/config.py:271-349), flag for flag."""
    p = argparse.ArgumentParser(
        description="facegen_torch GAN trainer, one CUDA GPU per process (reference: th train.lua)")
    p.add_argument("--batchSize", type=int, default=32, dest="batch_size")
    p.add_argument("--save", type=str, default="logs")
    p.add_argument("--saveFreq", type=int, default=30, dest="save_freq")
    p.add_argument("--network", type=str, default="")
    _add_bool(p, "--noplot", "do not write visualization grids")
    p.add_argument("--N_epoch", type=int, default=1000, dest="n_epoch")
    p.add_argument("--G_SGD_lr", type=float, default=0.02, dest="g_sgd_lr")
    p.add_argument("--G_SGD_momentum", type=float, default=0.0, dest="g_sgd_momentum")
    p.add_argument("--D_SGD_lr", type=float, default=0.02, dest="d_sgd_lr")
    p.add_argument("--D_SGD_momentum", type=float, default=0.0, dest="d_sgd_momentum")
    p.add_argument("--G_adam_lr", type=float, default=-1.0, dest="g_adam_lr")
    p.add_argument("--D_adam_lr", type=float, default=-1.0, dest="d_adam_lr")
    p.add_argument("--G_L1", type=float, default=0.0, dest="g_l1")
    p.add_argument("--G_L2", type=float, default=0.0, dest="g_l2")
    p.add_argument("--D_L1", type=float, default=0.0, dest="d_l1")
    p.add_argument("--D_L2", type=float, default=1e-4, dest="d_l2")
    p.add_argument("--D_iterations", type=int, default=1, dest="d_iterations")
    p.add_argument("--G_iterations", type=int, default=1, dest="g_iterations")
    p.add_argument("--D_maxAcc", type=float, default=1.01, dest="d_max_acc")
    p.add_argument("--D_clamp", type=float, default=1.0, dest="d_clamp")
    p.add_argument("--G_clamp", type=float, default=5.0, dest="g_clamp")
    p.add_argument("--D_optmethod", type=str, default="adam", dest="d_optmethod")
    p.add_argument("--G_optmethod", type=str, default="adam", dest="g_optmethod")
    p.add_argument("--threads", type=int, default=8, help="accepted; unused")
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    p.add_argument("--noiseDim", type=int, default=100, dest="noise_dim")
    p.add_argument("--window", type=int, default=3)
    p.add_argument("--scale", type=int, default=32)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--weightsVisFreq", type=int, default=0, dest="weights_vis_freq",
                   help="dump D's and G's activation grids every N steps (0 = off)")
    _add_bool(p, "--grayscale", "train on 1-channel images")
    _add_bool(p, "--denoise", "write samples_denoised.png through the denoiser trained at "
              "this scale (denoiser_{c}x{h}x{w} under --save)")
    _add_bool(p, "--aws", "AWS dataset path (train.lua:166-170)")
    p.add_argument("--coefL1", type=float, default=0.0, dest="coef_l1",
                   help="AE weight L1 penalty (AE/denoiser trainers only)")
    p.add_argument("--coefL2", type=float, default=0.0, dest="coef_l2",
                   help="AE weight L2 penalty (AE/denoiser trainers only)")
    p.add_argument("--AE_clamp", type=float, default=1.0, dest="ae_clamp",
                   help="denoiser gradient clamp, 0 = off (denoiser trainer only)")
    p.add_argument("--computeDtype", type=str, default="bfloat16", dest="compute_dtype",
                   choices=["bfloat16", "float32"])
    p.add_argument("--meshShape", type=str, default="-1", dest="mesh_shape",
                   help="'N' or '-1': data parallel over the N ranks of a process group, "
                        "one process per device (launch N processes with "
                        "FACEGEN_COORDINATOR, FACEGEN_NUM_PROCESSES, FACEGEN_PROCESS_ID), "
                        "each on its local batch; 'DP,MP': the 2-D data x model mesh over "
                        "DP*MP ranks, the single-device step on the global batch with the "
                        "large leaves sharded over MP (the GAN trainer; the c2f, AE and "
                        "denoiser trainers take any shape this way); '1' or '-1' without "
                        "a group: one device")
    p.add_argument("--epochs", type=int, default=-1,
                   help="number of epochs to run (-1 = forever)")
    p.add_argument("--epochsPerCompile", type=int, default=0, dest="epochs_per_compile",
                   help="train N epochs per chunk with one read-back of their results "
                        "(0 = auto: 8 under --noplot, else 1)")
    p.add_argument("--boundaryPad", type=int, default=0, dest="boundary_pad",
                   help="widen the G->D image interface to this many channels inside the "
                        "train step (an exact zero-weight reparameterisation; 0 = off)")
    _add_bool(p, "--modernInit", "disable the reference's gaussian-overwrite init")
    _add_bool(p, "--syntheticData", "use procedural faces (no LFW needed)")
    p.add_argument("--datasetDir", type=str, default=None, dest="dataset_dir")
    return p


def train_config_from_args(argv=None) -> TrainConfig:
    """Parse and validate; a flag value the config refuses exits with a
    parser error that says why."""
    p = train_arg_parser()
    a = p.parse_args(argv)
    try:
        mesh = tuple(int(v) for v in str(a.mesh_shape).split(","))
    except ValueError:
        p.error(f"--meshShape {a.mesh_shape!r}: not a comma-separated list of ints")
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    kw = {k: v for k, v in vars(a).items() if k in fields}
    kw.update(mesh_shape=mesh, reference_init=not a.modernInit,
              synthetic_data=a.syntheticData)
    try:
        return TrainConfig(**kw).validate()
    except ValueError as e:
        p.error(str(e))


def c2f_arg_parser() -> argparse.ArgumentParser:
    """facegen's c2f trainer CLI (train_c2f.py:12-53), flag for flag."""
    p = argparse.ArgumentParser(
        description="facegen_torch c2f trainer on one CUDA GPU (reference: th train_c2f.lua)")
    p.add_argument("--save", default="logs")
    p.add_argument("--saveFreq", type=int, default=30, dest="save_freq")
    p.add_argument("--network", default="")
    p.add_argument("--noplot", action="store_true")
    p.add_argument("--D_sgd_lr", type=float, default=0.02, dest="d_sgd_lr")
    p.add_argument("--G_sgd_lr", type=float, default=0.02, dest="g_sgd_lr")
    p.add_argument("--D_sgd_momentum", type=float, default=0.0, dest="d_sgd_momentum")
    p.add_argument("--G_sgd_momentum", type=float, default=0.0, dest="g_sgd_momentum")
    p.add_argument("--batchSize", type=int, default=32, dest="batch_size")
    p.add_argument("--N_epoch", type=int, default=1000, dest="n_epoch")
    p.add_argument("--G_L1", type=float, default=0.0, dest="g_l1")
    p.add_argument("--G_L2", type=float, default=0.0, dest="g_l2")
    p.add_argument("--D_L1", type=float, default=1e-7, dest="d_l1")
    p.add_argument("--D_L2", type=float, default=0.0, dest="d_l2")
    p.add_argument("--D_iterations", type=int, default=1, dest="d_iterations")
    p.add_argument("--G_iterations", type=int, default=1, dest="g_iterations")
    p.add_argument("--D_clamp", type=float, default=1.0, dest="d_clamp")
    p.add_argument("--G_clamp", type=float, default=5.0, dest="g_clamp")
    p.add_argument("--D_optmethod", default="adam", dest="d_optmethod")
    p.add_argument("--G_optmethod", default="adam", dest="g_optmethod")
    p.add_argument("--threads", type=int, default=4, help="accepted; unused")
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    p.add_argument("--noiseDim", type=int, default=100, dest="noise_dim")
    p.add_argument("--window", type=int, default=3)
    p.add_argument("--coarseSize", type=int, default=16, dest="coarse_size")
    p.add_argument("--fineSize", type=int, default=32, dest="fine_size")
    p.add_argument("--grayscale", action="store_true")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--aws", action="store_true")
    p.add_argument("--epochs", type=int, default=-1)
    p.add_argument("--syntheticData", action="store_true", dest="synthetic_data")
    p.add_argument("--datasetDir", default=None, dest="dataset_dir")
    p.add_argument("--meshShape", type=str, default="-1", dest="mesh_shape",
                   help="'N' or 'DP,MP' ranks of a process group (the 2-D data x model "
                        "mesh, global-batch semantics; 'N' is 'N,1'); '1' or '-1' without "
                        "one: one device")
    p.add_argument("--boundaryPad", type=int, default=0, dest="boundary_pad",
                   help="widen the diff/coarse image interface to this many channels inside "
                        "the train step (an exact zero-weight reparameterisation; 0 = off)")
    return p


def c2f_config_from_args(argv=None) -> C2FConfig:
    """Parse and validate; a flag value the config refuses exits with a
    parser error that says why."""
    p = c2f_arg_parser()
    a = p.parse_args(argv)
    try:
        mesh = tuple(int(v) for v in str(a.mesh_shape).split(","))
    except ValueError:
        p.error(f"--meshShape {a.mesh_shape!r}: not a comma-separated list of ints")
    try:
        return C2FConfig(**dict(vars(a), mesh_shape=mesh)).validate()
    except ValueError as e:
        p.error(str(e))


def cli_device(gpu: int, cli: str):
    """``cuda:{gpu}`` for a command line; exits with an error when there
    is no CUDA GPU or no such device."""
    import sys

    import torch

    if not torch.cuda.is_available():
        sys.exit(f"no CUDA GPU: the {cli} CLI runs on cuda:{{--gpu}} only")
    if not 0 <= gpu < torch.cuda.device_count():
        sys.exit(f"--gpu {gpu}: {torch.cuda.device_count()} CUDA device(s) visible")
    return torch.device("cuda", gpu)
