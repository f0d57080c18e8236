"""Typed configuration for the OverlapNet PyTorch port.

A copy of the JAX package's ``core/config.py``: the same YAML schema, the
same dataclasses and the same defaults, so one network.yml drives both
packages. Kept as a copy so that the port imports nothing of the JAX package.

The reference drives everything from two loosely-typed YAML files
(reference: config/network.yml, config/demo.yml) with per-key inline
defaulting at every consumer (reference: src/two_heads/training.py:137-190,
infer.py:36-84). Here the same knobs live in dataclasses with defaults in
exactly one place, and ``load_config`` accepts the reference's YAML schema
unchanged so existing network.yml files keep working.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import yaml


@dataclass
class ChannelConfig:
    """Input-channel toggles.

    Channel-count rule mirrors reference src/two_heads/training.py:162-176:
    C = 1*depth + 3*normals + (3 if pca else 20)*class_probs + 1*intensity.
    """

    use_depth: bool = True
    use_normals: bool = True
    use_class_probabilities: bool = False
    use_class_probabilities_pca: bool = False
    use_intensity: bool = False

    @property
    def num_channels(self) -> int:
        n = 0
        if self.use_depth:
            n += 1
        if self.use_normals:
            n += 3
        if self.use_class_probabilities:
            n += 3 if self.use_class_probabilities_pca else 20
        if self.use_intensity:
            n += 1
        return n

    def channel_kinds(self) -> list[tuple[str, int]]:
        """Ordered (kind, width) channel layout, matching the loader order of
        reference src/two_heads/ImagePairOverlapOrientationSequence.py:142-207:
        depth, normal, probability[_pca], intensity."""
        kinds = []
        if self.use_depth:
            kinds.append(("depth", 1))
        if self.use_normals:
            kinds.append(("normal", 3))
        if self.use_class_probabilities:
            if self.use_class_probabilities_pca:
                kinds.append(("probability_pca", 3))
            else:
                kinds.append(("probability", 20))
        if self.use_intensity:
            kinds.append(("intensity", 1))
        return kinds


@dataclass
class ModelConfig:
    """Model architecture selection (reference: config/network.yml:64-82)."""

    model_type: str = "SiameseNetworkTemplate"
    legs_type: str = "360OutputkLegs"
    overlap_head: str = "DeltaLayerConv1NetworkHead"
    orientation_head: str = "CorrelationHead"
    # (H, W) of one input range image; channel count comes from ChannelConfig.
    input_height: int = 64
    input_width: int = 900
    strides_layer1: tuple[int, int] = (2, 2)
    additional_unsymmetric_layer3a: bool = True
    # Width of the 1xS / Sx1 convs in the overlap head
    # (reference: generateNet.py:88-89).
    conv1_network_head_conv1size: int = 15
    small_net: bool = False
    # Freeze leg weights ("360OutputkLegsFixed", reference generateNet.py:222).
    legs_trainable: bool = True
    # Normalization mode of the correlation head: none|euclidean|scaling|
    # standardization (reference: NormalizedCorrelation2D.py:55-73; production
    # uses 'none', generateNet.py:343).
    correlation_normalize: str = "none"
    # Detach the correlation head from the legs during training (see
    # models/siamese.py OverlapNet.score); reference parity = False.
    correlation_stop_gradient: bool = False
    # Yaw-head backend: 'fft' | 'conv' (grouped MXU conv) | 'auto'.
    correlation_method: str = "fft"
    # Overlap-head backend for the fused delta+c_conv1:
    # 'xla' broadcast-diff + conv (XLA fuses; fastest on TPU),
    # 'blocked' explicit i-blocked contraction, 'pallas' Pallas kernel.
    # Kept for YAML compatibility only: the PyTorch port does not read it
    # (models/heads.py picks the CUDA kernel or its plain version by device).
    delta_head_impl: str = "xla"
    # Compute dtype for the forward pass ('float32' or 'bfloat16').
    compute_dtype: str = "float32"
    # Width padding of the leg convs. 'valid' = reference parity
    # (generateNet.py:119-219): the 900-col panorama collapses to a 360-bin
    # feature window, so the correlation is NOT truly circular — yaw
    # aliases beyond |144| degrees and equivariance breaks at the borders.
    # 'circular' wrap-pads the width (the range image IS a 360-degree
    # panorama), giving an exactly periodic 450-bin feature space: the
    # correlation is genuinely circular, yaw is alias-free over the full
    # +/-180 degrees, and input-roll equivariance is exact. Same layer
    # names/kernel shapes (checkpoint-compatible).
    leg_padding: str = "valid"
    # Yaw convention (ops/yaw.py): 'calibrated' places training targets at
    # the bin where the correlation peak physically lands and decodes with
    # the measured bins-per-degree factor (1.25 for the 900-col/stride-2
    # geometry); 'reference' reproduces the reference's 1-bin-per-degree
    # readout (infer.py:158), which over-reports yaw by 25%.
    yaw_space: str = "calibrated"
    # Compute dtype for the leg conv stack specifically; empty = inherit
    # compute_dtype. Default bfloat16: the legs are MXU-bound and bf16 is
    # ~55% faster on TPU (BENCH_SHOOTOUT_r03 leg_variants) while params and
    # the pairwise heads stay float32; numerics are gated by the golden
    # forward test (overlap drift < 5e-3, yaw argmax exact).
    leg_dtype: str = "bfloat16"


@dataclass
class TrainConfig:
    """Training hyperparameters (reference: config/network.yml:41-57,
    training.py:47-57, 215-230, 253-259)."""

    learning_rate: float = 0.001
    lr_alpha: float = 0.99
    momentum: float = 0.5  # parsed but unused by the reference optimizer too
    batch_size: int = 16
    no_batches_in_epoch: int = 100_000_000_000
    no_epochs: int = 100
    no_test_pairs: int = 100_000_000_000
    min_overlap_for_angle: float = 0.7
    # Soft yaw supervision floor: when in [0, min_overlap_for_angle), the
    # orientation CE's binarization becomes a linear ramp over the
    # (soft, hard) overlap band (train/losses.py), so yaw is trained —
    # with overlap-proportional weight — exactly where the LCD engine
    # accepts closures (overlap > 0.3). -1 = reference-parity hard cutoff
    # (yaw unsupervised below 0.7; measured ~50 deg RMS there, RESULTS_r04).
    yaw_soft_overlap_min: float = -1.0
    # 0: no rotation aug; 1: fixed random shift per pair; 2: re-rolled each
    # epoch (reference ImagePairOverlapOrientationSequence.py:42-53).
    rotate_training_data: int = 0
    # Loss weights overlap:orientation (reference training.py:257).
    overlap_loss_weight: float = 5.0
    orientation_loss_weight: float = 1.0
    # 'adagrad' = reference parity (training.py:253); 'adam' converges much
    # faster on this net (adagrad's effective LR collapses after ~1 epoch).
    optimizer: str = "adagrad"
    # Global-norm gradient clip (0 = off). The saturated correlation logits
    # at init produce leg gradients ~1000x the param norm; clipping keeps
    # the first steps from killing the ReLUs.
    grad_clip_norm: float = 0.0
    # Restrict the orientation CE to pairs with a labeled yaw bin
    # (overlap > min_overlap_for_angle); reference parity = False.
    mask_zero_orientation: bool = False
    # Staged yaw training: epoch index from which the orientation CE's
    # gradient is allowed through the legs (flips off
    # ModelConfig.correlation_stop_gradient). -1 = never release. Joint
    # training from scratch stalls overlap learning (TRAINABILITY_AB.json);
    # releasing after overlap converges sharpens the correlation peak
    # without that failure mode.
    correlation_release_epoch: int = -1
    # Adjust the yaw label for the rotate_data circular shift: the reference
    # rolls the right image but leaves the label untouched (SURVEY.md §2
    # quirk — its aug only helps overlap). With this on, the label moves by
    # -round(shift * W'/W) bins (leg-output space), making the aug a
    # legitimate yaw-training signal. Sign/scale property-tested in
    # tests/test_models.py.
    rotate_adjust_yaw_labels: bool = False
    # Host-side dtype of the image batch ('float32' | 'bfloat16'); bfloat16
    # halves host->device transfer, the bottleneck on a remote-TPU link.
    input_dtype: str = "float32"
    # Device-resident training: number of optimizer steps fused into one
    # dispatch (lax.scan over stacked index batches). On a remote-TPU link
    # each dispatch costs ~the link latency (~20-30 ms), which dominates
    # small-batch steps; K steps/dispatch amortizes it. 1 = one dispatch
    # per step (reference-like loop). Keep 1 on the CPU backend — there is
    # no dispatch latency to amortize and the scanned full-size train step
    # costs minutes of XLA:CPU compile time.
    steps_per_dispatch: int = 1
    seed: int = 1234


@dataclass
class DataConfig:
    """Dataset paths and sequence selection (reference: network.yml:26-39,
    demo.yml)."""

    data_root_folder: str = "data/"
    imgpath: str = ""  # defaults to data_root_folder when empty
    training_seqs: Sequence[str] = field(default_factory=list)
    testing_seqs: Sequence[str] = field(default_factory=list)
    infer_seqs: str = ""
    traindata_npzfile: str = ""
    validationdata_npzfile: str = ""
    testdata_npzfile: str = ""

    @property
    def image_root(self) -> str:
        return self.imgpath if self.imgpath else self.data_root_folder


@dataclass
class ExperimentConfig:
    experiments_path: str = "/tmp"
    testname: str = "experiment"
    pretrained_weightsfilename: str = ""
    show_plots: bool = False


@dataclass
class OverlapNetConfig:
    channels: ChannelConfig = field(default_factory=ChannelConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    experiment: ExperimentConfig = field(default_factory=ExperimentConfig)

    @property
    def num_input_channels(self) -> int:
        return self.channels.num_channels

    @property
    def input_shape(self) -> tuple[int, int, int]:
        return (self.model.input_height, self.model.input_width, self.num_input_channels)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _seq_list(value: Any) -> list[str]:
    """Sequences appear as space-separated strings in the reference YAML
    (network.yml:33-39, split at training.py:126-127)."""
    if value is None:
        return []
    if isinstance(value, str):
        return value.split()
    return [str(v) for v in value]


def config_from_dict(raw: Mapping[str, Any]) -> OverlapNetConfig:
    """Build a typed config from the reference's network.yml dict schema."""
    cfg = OverlapNetConfig()

    ch = cfg.channels
    ch.use_depth = bool(raw.get("use_depth", ch.use_depth))
    ch.use_normals = bool(raw.get("use_normals", ch.use_normals))
    ch.use_class_probabilities = bool(
        raw.get("use_class_probabilities", ch.use_class_probabilities)
    )
    ch.use_class_probabilities_pca = bool(
        raw.get("use_class_probabilities_pca", ch.use_class_probabilities_pca)
    )
    ch.use_intensity = bool(raw.get("use_intensity", ch.use_intensity))

    m = cfg.model
    model_raw = raw.get("model", {}) or {}
    m.model_type = model_raw.get("modelType", m.model_type)
    m.legs_type = model_raw.get("legsType", m.legs_type)
    m.overlap_head = model_raw.get("overlap_head", m.overlap_head)
    m.orientation_head = model_raw.get("orientation_head", m.orientation_head)
    shape = model_raw.get("inputShape")
    if shape:
        m.input_height, m.input_width = int(shape[0]), int(shape[1])
    strides = model_raw.get("strides_layer1")
    if strides:
        m.strides_layer1 = (int(strides[0]), int(strides[1]))
    m.additional_unsymmetric_layer3a = bool(
        model_raw.get("additional_unsymmetric_layer3a", m.additional_unsymmetric_layer3a)
    )
    if "leg_output_width" in model_raw:
        # The reference YAML declares this (network.yml:77) but the true value
        # is a function of the conv stack; validate instead of storing a knob
        # nothing reads. (core.leg_specs is dependency-free, so plain config
        # parsing stays lightweight.)
        from overlapnet_torch.core.leg_specs import leg_output_width as _derived_width

        declared = int(model_raw["leg_output_width"])
        derived = _derived_width(m)
        if declared != derived:
            raise ValueError(
                f"config leg_output_width={declared} does not match the width "
                f"derived from the conv stack ({derived}) for input_width="
                f"{m.input_width}"
            )
    m.conv1_network_head_conv1size = int(
        model_raw.get("conv1NetworkHead_conv1size", m.conv1_network_head_conv1size)
    )
    m.legs_trainable = not m.legs_type.endswith("Fixed")
    m.correlation_method = model_raw.get("correlation_method", m.correlation_method)
    m.delta_head_impl = model_raw.get("delta_head_impl", m.delta_head_impl)
    m.compute_dtype = model_raw.get("compute_dtype", m.compute_dtype)
    m.leg_dtype = model_raw.get("leg_dtype", m.leg_dtype)
    m.yaw_space = model_raw.get("yaw_space", m.yaw_space)
    m.leg_padding = model_raw.get("leg_padding", m.leg_padding)

    t = cfg.train
    t.learning_rate = float(raw.get("learning_rate", t.learning_rate))
    t.lr_alpha = float(raw.get("lr_alpha", t.lr_alpha))
    t.momentum = float(raw.get("momentum", t.momentum))
    t.batch_size = int(raw.get("batch_size", t.batch_size))
    t.no_batches_in_epoch = int(raw.get("no_batches_in_epoch", t.no_batches_in_epoch))
    t.no_epochs = int(raw.get("no_epochs", t.no_epochs))
    t.no_test_pairs = int(raw.get("no_test_pairs", t.no_test_pairs))
    t.min_overlap_for_angle = float(
        raw.get("min_overlap_for_angle", t.min_overlap_for_angle)
    )
    t.yaw_soft_overlap_min = float(
        raw.get("yaw_soft_overlap_min", t.yaw_soft_overlap_min)
    )
    t.rotate_training_data = int(raw.get("rotate_training_data", t.rotate_training_data))
    t.optimizer = str(raw.get("optimizer", t.optimizer))
    t.grad_clip_norm = float(raw.get("grad_clip_norm", t.grad_clip_norm))
    t.input_dtype = str(raw.get("input_dtype", t.input_dtype))
    t.mask_zero_orientation = bool(raw.get("mask_zero_orientation", t.mask_zero_orientation))
    t.correlation_release_epoch = int(
        raw.get("correlation_release_epoch", t.correlation_release_epoch)
    )
    t.rotate_adjust_yaw_labels = bool(
        raw.get("rotate_adjust_yaw_labels", t.rotate_adjust_yaw_labels)
    )

    d = cfg.data
    d.data_root_folder = raw.get("data_root_folder", d.data_root_folder)
    d.imgpath = raw.get("imgpath", d.imgpath)
    d.training_seqs = _seq_list(raw.get("training_seqs"))
    d.testing_seqs = _seq_list(raw.get("testing_seqs"))
    d.infer_seqs = raw.get("infer_seqs", d.infer_seqs)
    d.traindata_npzfile = raw.get("traindata_npzfile", d.traindata_npzfile)
    d.validationdata_npzfile = raw.get("validationdata_npzfile", d.validationdata_npzfile)
    d.testdata_npzfile = raw.get("testdata_npzfile", d.testdata_npzfile)

    if (
        t.rotate_adjust_yaw_labels
        and t.rotate_training_data > 0
        and m.yaw_space == "reference"
    ):
        # The shift-adjusted label moves by round(shift * W'/W) reference
        # bins, which composes with the physical peak position only through
        # yaw_space='calibrated'; under 'reference' the adjusted targets
        # disagree with the equivariant peak by ~0.1 bins per shifted column
        # — contradictory supervision (ADVICE r4).
        raise ValueError(
            "rotate_adjust_yaw_labels=True requires yaw_space='calibrated': "
            "under yaw_space='reference' the shift-adjusted labels disagree "
            "with the physically equivariant correlation peak"
        )

    e = cfg.experiment
    e.experiments_path = raw.get("experiments_path", e.experiments_path)
    e.testname = raw.get("testname", e.testname)
    e.pretrained_weightsfilename = raw.get(
        "pretrained_weightsfilename", e.pretrained_weightsfilename
    )
    e.show_plots = bool(raw.get("show_plots", e.show_plots))

    return cfg


def load_config(path: str) -> OverlapNetConfig:
    """Load a network.yml-style YAML file into a typed config."""
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    return config_from_dict(raw)
