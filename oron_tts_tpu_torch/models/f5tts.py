"""F5TTS facade: text → waveform, ref-free or voice-cloned (PyTorch).

Counterpart of the JAX package's ``models/f5tts.py`` synthesis path:
validate, split long text at punctuation or word boundaries, estimate the
duration (explicit → ref-ratio → chars·13/speed, at least 50 frames),
stretch the token ids to the mel length, pad to a bucket of
``pad_to_multiple`` frames, run the CFG Euler sampler, and vocode with the
bundled Vocos checkpoint. Every row of every solve (a text, or one chunk of a
long text: chunk i with seed ``seed + i``) draws its noise from its own seed
(``cfm.per_row_noise``), so rows are length-grouped and solved together
without changing any of them: ``synthesize_batch`` for many texts,
``synthesize_stream`` for pieces in playback order, and ``synthesize`` itself
for the chunks of a paragraph. ``quantize_for_serving`` switches the loaded
backbone to int8 weights in memory.

The backbone is the one ``model.backbone`` names (:data:`BACKBONES`,
:func:`build_backbone`): the F5-TTS DiT by default, E2 TTS's UNetT
(``models/unett.py``, ``configs/e2_base.yaml``) or F5-TTS's two-stream MMDiT
(``models/mmdit.py``, ``configs/mmdit_base.yaml``; TP 1 only), which train, sample
and shard through the same methods (``models/backbone.py``).

Runs on the card unless ``device="cpu"`` is given; without CUDA and
without that request it raises.

Multi-GPU serving (``set_mesh``): every rank of a ``DP × TP`` mesh
(``parallel/mesh.py``) calls the same method with the same arguments. The
backbone's attention and FFN projections shard over the model group (Megatron
TP), the vocoder stays whole on every rank. ``synthesize_batch`` pads each
length group to a multiple of the data size and each data rank solves and
decodes its block of rows; the waveforms are gathered over the data group,
so every rank returns the whole answer. A solve whose rows the data size
does not divide (a one-chunk ``synthesize``) runs whole on every data rank,
with TP still sharding its math.

Precision. The backbone computes in ``dtype`` (bf16 on the card): its
parameters are a working set in that type. Training (``train/trainer.py``)
keeps f32 master weights, moments and EMA outside the module and copies the
masters into the working set after every update, where the JAX package
keeps f32 parameters and casts kernel and input at each ``Dense``. The
products are the same, and inference runs exactly as before.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import re
from pathlib import Path
from collections.abc import Iterator
from typing import Any, NamedTuple

import numpy as np
import torch

from oron_tts_tpu_torch.config import F5Config, ModelConfig
from oron_tts_tpu_torch.models.backbone import Backbone
from oron_tts_tpu_torch.models.cfm import CFM
from oron_tts_tpu_torch.models.dit import DiT, quantize_dit_params
from oron_tts_tpu_torch.models.mmdit import MMDiT
from oron_tts_tpu_torch.models.unett import UNetT
from oron_tts_tpu_torch.models.vocos import VocosDecoder, convert_vocos_state_dict
from oron_tts_tpu_torch.ops.audio import AudioProcessor
from oron_tts_tpu_torch.parallel import mesh as pmesh
from oron_tts_tpu_torch.text import TextCleaner, validate_language
from oron_tts_tpu_torch.text.align import stretch_text_to_len
from oron_tts_tpu_torch.utils.device import default_dtype, resolve_device
from oron_tts_tpu_torch.utils.weights import from_flax_params, load_npz_tree

_logger = logging.getLogger(__name__)

_KZ_ONLY_CHARS = frozenset("әғқңұһі")
DEFAULT_MAX_CHARS_PER_CHUNK = 120
DEFAULT_PAUSE_S = 0.25
_MAJOR_BREAKS = ".!?…"
_MINOR_BREAKS = ",;:"
# the vocoder weights are shared with the JAX package as a file, read by path
BUNDLED_VOCODER = (
    Path(__file__).resolve().parents[2] / "oron_tts_tpu" / "assets" / "vocoder"
    / "vocos_default.npz"
)


def _looks_like_hub_id(spec: str) -> bool:
    """True for ``org/name``-shaped specs that are not filesystem paths.

    A hub id has exactly one slash and no path-like prefix or weight-file
    suffix, so a real (even missing) local path is never taken for one.
    """
    if spec.startswith((".", "/", "~")) or spec.count("/") != 1:
        return False
    return not spec.endswith((".npz", ".pt", ".bin", ".safetensors", ".ckpt"))


def _normalize_ws(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _find_split_index(text: str, max_chars: int) -> int:
    upper = min(max_chars, len(text))
    lower = max(1, int(max_chars * 0.55))
    for breaks in (_MAJOR_BREAKS, _MINOR_BREAKS, " "):
        for idx in range(upper, lower, -1):
            if text[idx - 1] in breaks:
                return idx
    return upper


def split_text_for_synthesis(text: str, max_chars: int) -> list[str]:
    """Split long text into chunks near punctuation or word boundaries."""
    normalized = _normalize_ws(text)
    if not normalized:
        return []
    if max_chars < 1:
        return [normalized]
    chunks: list[str] = []
    remaining = normalized
    while len(remaining) > max_chars:
        cut = _find_split_index(remaining, max_chars)
        piece = remaining[:cut].strip()
        if piece:
            chunks.append(piece)
        remaining = remaining[cut:].strip()
    if remaining:
        chunks.append(remaining)
    return chunks


def _chunk_seeds(seed: int | None, n: int) -> list[int]:
    """The serial chunk-seed rule: chunk (or text) idx gets ``seed + idx``, base 0 unseeded."""
    base = 0 if seed is None else seed
    return [base + i for i in range(n)]


def concat_with_pause(waveforms: list[np.ndarray], sample_rate: int, pause_s: float) -> np.ndarray:
    if not waveforms:
        return np.empty(0, dtype=np.float32)
    pause_len = int(sample_rate * pause_s)
    if len(waveforms) == 1 or pause_len <= 0:
        return np.concatenate(waveforms)
    pause = np.zeros(pause_len, dtype=waveforms[0].dtype)
    parts: list[np.ndarray] = []
    for i, w in enumerate(waveforms):
        if i:
            parts.append(pause)
        parts.append(w)
    return np.concatenate(parts)


# ``model.backbone``'s names, as ``config.BACKBONE_DEFAULTS`` has them
BACKBONES: dict[str, type[Backbone]] = {"DiT": DiT, "UNetT": UNetT, "MMDiT": MMDiT}


def build_backbone(m: ModelConfig, n_mels: int, gradient_checkpointing: bool,
                   use_flash: bool = True) -> Backbone:
    """The backbone that ``m.backbone`` names, at ``m``'s widths."""
    return BACKBONES[m.backbone].from_config(m, n_mels, gradient_checkpointing, use_flash)


def config_param_count(config: dict[str, Any]) -> int:
    """Parameters of the backbone a config dict names, as its class counts them
    (:meth:`Backbone.param_count`), for ``utils/memory.py``'s estimate."""
    c = F5Config.from_dict(config)
    return BACKBONES[c.model.backbone].param_count(c.model, c.audio.n_mels)


def config_activation_depth(config: dict[str, Any]) -> int:
    """Block-streams whose activations a training step of the config's backbone holds
    (:meth:`Backbone.activation_depth`), for ``utils/memory.py``'s estimate."""
    m = F5Config.from_dict(config).model
    return BACKBONES[m.backbone].activation_depth(m)


class F5TTS:
    """DiT, UNetT or MMDiT backbone + CFM sampler + audio front end + Vocos vocoder."""

    def __init__(
        self,
        config: F5Config,
        device: str | torch.device | None = None,
        dtype: torch.dtype | None = None,
        pad_to_multiple: int = 64,
        use_flash: bool | None = None,
    ) -> None:
        """``use_flash`` as in the JAX facade: None or True runs the flash
        kernels (lanes, or the classic layout where the heads do not fit
        lanes), False the einsum attention."""
        self.config = config
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        m, a = config.model, config.audio
        self.n_mels, self.sample_rate, self.hop_length = a.n_mels, a.sample_rate, a.hop_length
        self.pad_to_multiple = pad_to_multiple
        self.text_cleaner = TextCleaner()
        self.audio_processor = AudioProcessor(
            sample_rate=a.sample_rate, n_fft=a.n_fft, hop_length=a.hop_length,
            win_length=a.win_length, n_mels=a.n_mels, device=self.device,
        )
        self.backbone = build_backbone(
            m, a.n_mels, bool(config.gradient_checkpointing),
            use_flash=True if use_flash is None else use_flash,
        ).to(device=self.device, dtype=self.dtype).eval()
        self.cfm = CFM(
            self.backbone, n_mels=a.n_mels, audio_drop_prob=m.audio_drop_prob,
            cond_drop_prob=m.cond_drop_prob, frac_lengths_mask=m.frac_lengths_mask,
        )
        self.params_loaded = False
        self.quant_mode: str | None = None
        self.vocoder: VocosDecoder | str | None = None  # or "griffin_lim"
        # per-token duration calibration (data/duration_stats.py), fitted on
        # the training corpus and carried in config.json; None keeps chars·13
        self.duration_stats: dict[str, Any] | None = None
        self.mesh: pmesh.Mesh | None = None

    # ── multi-GPU (TP over "model", DP over "data") ──────────────────────

    def set_mesh(self, mesh: pmesh.Mesh | None) -> None:
        """Shard the loaded backbone over ``mesh``'s model group; ``None`` gathers it back.

        The rules are the trainer's (``parallel/mesh.py``); the vocoder stays
        whole. w8a16 ``int8`` is single-device, as in the JAX package.
        """
        if mesh is not None and self.quant_mode == "int8":
            raise NotImplementedError(
                "w8a16 int8 serving is single-device (its kernel has no sharded "
                "form); use mode='int8_dynamic' — a plain s8 product that shards "
                "like any matmul — or reload full-precision weights before set_mesh")
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"the mesh's device {mesh.device} is not the model's {self.device}")
        if self.mesh is not None:
            self.backbone.unshard()
        self.mesh = mesh
        self.cfm.mesh = mesh
        if mesh is not None:
            self.backbone.shard(mesh)

    @contextlib.contextmanager
    def _whole(self) -> Iterator[None]:
        """The backbone gathered whole inside the block and sharded again after it (a
        no-op without a mesh)."""
        mesh = self.mesh
        self.set_mesh(None)
        yield
        self.set_mesh(mesh)

    @property
    def _row_multiple(self) -> int:
        """``synthesize_batch`` groups are padded to a multiple of the data size."""
        return 1 if self.mesh is None else self.mesh.n_data

    def set_duration_stats(self, stats: dict[str, Any] | None) -> None:
        """Install (or clear) the calibrated ref-free duration table."""
        if stats is not None and not stats.get("fpc"):
            stats = None
        self.duration_stats = stats

    @classmethod
    def from_config(cls, config: dict[str, Any] | F5Config, **kwargs: Any) -> "F5TTS":
        if isinstance(config, dict):
            config = F5Config.from_dict(config)
        return cls(config, **kwargs)

    # ── parameters ───────────────────────────────────────────────────────

    def init_params(self, seed: int = 0) -> None:
        """Fresh parameters under the backbone's own initial scheme
        (:meth:`Backbone.initial_params`: the JAX package's for the DiT)."""
        with self._whole():  # the scheme reads whole tensors
            self.load_params(self.backbone.initial_params(seed))

    def num_params(self) -> int:
        """Values in the backbone, int8 weights and their scales included."""
        return sum(t.numel() for t in self.backbone.state_dict().values())

    def weight_bytes(self) -> int:
        """Bytes the backbone's weights hold on the device."""
        return sum(t.numel() * t.element_size() for t in self.backbone.state_dict().values())

    def load_params(self, flax_params: dict[str, Any]) -> None:
        """Load a backbone parameter tree in the JAX package's flax layout.

        Under a mesh each rank keeps its shards of the whole tree it is given.
        """
        with self._whole():
            self.backbone.load_state_dict(from_flax_params(flax_params), strict=True)
        self.params_loaded = True

    def load_checkpoint(self, path: str | Path) -> None:
        """Load a backbone ``.npz`` checkpoint written by the JAX package."""
        trees = load_npz_tree(path)
        self.load_params(trees.get("ema") or trees.get("params") or trees)

    def quantize_for_serving(self, mode: str = "int8") -> None:
        """Switch the loaded model to int8-weight serving, in memory only.

        ``mode="int8"`` is w8a16: int8 weights dequantized inside the matmul
        kernel (``ops/quantized_matmul.py``), half the weight bytes of bf16
        and near-lossless. ``mode="int8_dynamic"`` is w8a8: activations are
        quantized per token as well and the product is s8×s8→s32 (larger
        numeric error). Checkpoints on disk stay full precision; call this
        after loading.
        """
        if not self.params_loaded:
            raise RuntimeError("load or init params before quantizing")
        if self.mesh is not None and mode == "int8":
            raise NotImplementedError(
                "w8a16 int8 serving is single-device (its kernel has no sharded "
                "form); use 'int8_dynamic' under a mesh, or call set_mesh(None) first")
        with self._whole():  # per-channel scales over whole rows, then the shards
            quantize_dit_params(self.backbone, mode)  # raises on an unknown mode
            self.quant_mode = mode

    def _bucket(self, n: int) -> int:
        """Round a frame count up to the bucket multiple."""
        return -(-n // self.pad_to_multiple) * self.pad_to_multiple

    # ── training ─────────────────────────────────────────────────────────

    def forward(
        self,
        mel: torch.Tensor,
        text_ids: torch.Tensor,
        lens: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        x0: torch.Tensor | None = None,
        train: bool = True,
    ) -> torch.Tensor:
        """CFM loss; ``lens`` is lengths ``[B]`` or a bool mask ``[B, T]``.

        ``generator`` (a CPU ``torch.Generator``) takes the place of the JAX
        facade's ``rng``, whose default is key 0: here a generator seeded
        with 0. ``x0`` overrides the drawn noise.
        """
        if not self.params_loaded:
            raise RuntimeError("call init_params or load a checkpoint")
        lens = None if lens is None else torch.as_tensor(lens)
        if lens is not None and lens.dtype == torch.bool and lens.ndim == 2:
            lens = lens.sum(dim=-1).to(torch.int32)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return self.cfm.loss(torch.as_tensor(mel).to(self.device), torch.as_tensor(text_ids),
                             lens, generator, train=train, x0=x0)

    # ── vocoder ──────────────────────────────────────────────────────────

    def set_vocoder(self, module: torch.nn.Module,
                    state_dict: dict[str, torch.Tensor] | None = None) -> None:
        """Install a vocoder (a ``VocosDecoder`` or a module with its call).

        ``state_dict`` is loaded into ``module`` first, when given; the module
        moves to the model's device. Nothing decoded for the previous vocoder
        is kept: ``_decode_mel_group`` reads ``self.vocoder`` at every call.
        """
        if state_dict is not None:
            module.load_state_dict(state_dict, strict=True)
        self.vocoder = module.to(self.device).eval()

    def load_vocoder(self, checkpoint_path: str | Path | None = None) -> None:
        """Load a Vocos checkpoint: the port's ``.npz`` or the official torch layout.

        Resolution: explicit path → ``ORON_VOCOS_CKPT`` → the bundled file.
        ``"griffin_lim"`` (either way) selects the Griffin-Lim phase
        estimation, explicitly. An ``.npz`` reads its ``config.json``
        sidecar; a ``.pt``/``.bin``/``.safetensors`` file in the official
        Vocos layout (``backbone.embed``, ``backbone.convnext.{i}.*``,
        ``head.out``) loads through ``convert_vocos_state_dict`` into the
        mag/phase head, its size read from the tensors. A path that does not
        exist raises ``FileNotFoundError`` (the JAX package falls back to
        Griffin-Lim there); so does a hub id such as
        ``"charactr/vocos-mel-24khz"``: the port fetches nothing, the weights
        must be given as a local file.
        """
        spec = checkpoint_path or os.environ.get("ORON_VOCOS_CKPT")
        if spec is not None and str(spec) == "griffin_lim":
            _logger.info("Griffin-Lim vocoder explicitly selected")
            self.vocoder = "griffin_lim"
            return
        path = Path(spec or BUNDLED_VOCODER)
        if not path.exists():
            if _looks_like_hub_id(str(spec)):
                raise FileNotFoundError(
                    f"vocoder {str(spec)!r} looks like a hub id: the port downloads nothing; "
                    "fetch the Vocos weights and pass the local .safetensors/.bin/.pt file")
            raise FileNotFoundError(f"no Vocos checkpoint at {path}")
        if path.suffix == ".npz":
            trees = load_npz_tree(path)
            params = trees.get("ema") or trees.get("params") or trees
            cfg_path = path.parent / "config.json"
            voc_cfg = json.loads(cfg_path.read_text()) if cfg_path.exists() else {}
            dim = voc_cfg.get("dim", 512)
            n_layers = voc_cfg.get("n_layers", 8)
            intermediate_dim = voc_cfg.get("intermediate_dim", 1536)
            head_mode = voc_cfg.get("head_mode", "real_imag")
            layer_scale = bool(voc_cfg.get("layer_scale", False))
        else:
            from oron_tts_tpu_torch.utils.torch_compat import load_torch_checkpoint

            sd = load_torch_checkpoint(path)
            n_layers = 1 + max(int(k.split(".")[2]) for k in sd
                               if k.startswith("backbone.convnext."))
            params = convert_vocos_state_dict(sd, n_layers=n_layers)
            dim = int(sd["backbone.embed.weight"].shape[0])
            intermediate_dim = int(sd["backbone.convnext.0.pwconv1.weight"].shape[0])
            head_mode = "mag_phase"
            layer_scale = any(k.endswith(".gamma") for k in sd)
        module = VocosDecoder(
            n_mels=self.n_mels, dim=dim, n_layers=n_layers, intermediate_dim=intermediate_dim,
            n_fft=self.config.audio.n_fft, hop_length=self.hop_length,
            head_mode=head_mode, layer_scale=layer_scale,
        )
        module.load_state_dict(from_flax_params(params), strict=True)
        # the vocoder runs in f32 on every device, as in the JAX package
        self.vocoder = module.to(self.device).eval()

    def _decode_mel(self, mel: torch.Tensor) -> np.ndarray:
        """[1, n_mels, T] log-mel → waveform [T·hop]."""
        T = mel.shape[-1]
        return self._decode_mel_group(mel, [T])[0, : T * self.hop_length].cpu().numpy()

    @torch.no_grad()
    def _decode_mel_group(self, mel: torch.Tensor, lens: list[int]) -> torch.Tensor:
        """[B, n_mels, T] log-mels → waveforms [B, ≥T·hop] on the device, one vocoder call
        (Griffin-Lim: one a row).

        Decoded at the bucket length. ``lens`` makes a row independent of the
        bucket and of its neighbours: mel beyond a row's length is zeroed and
        the vocoder drops pad-frame STFT contributions, so row i's first
        ``lens[i]·hop`` samples are what it gives alone.
        """
        if self.vocoder is None:
            self.load_vocoder()
        T = mel.shape[-1]
        mel = torch.nn.functional.pad(mel.float(), (0, self._bucket(T) - T))
        if self.vocoder == "griffin_lim":  # row by row, each at its own length
            from oron_tts_tpu_torch.ops.griffin_lim import griffin_lim

            out = torch.zeros(mel.shape[0], mel.shape[-1] * self.hop_length, device=self.device)
            for i, n in enumerate(lens):
                out[i, : n * self.hop_length] = griffin_lim(
                    mel[i: i + 1, :, :n], self.audio_processor.mel_config, n_iter=32)[0]
            return out
        lens_t = torch.tensor(lens, device=self.device)
        valid = torch.arange(mel.shape[-1], device=self.device)[None, :] < lens_t[:, None]
        return self.vocoder(torch.where(valid[:, None, :], mel, 0.0), lens_t)

    # ── inference ────────────────────────────────────────────────────────

    @staticmethod
    def _warn_lang_contamination(text: str, lang: str) -> None:
        if validate_language(lang) == "mn":
            bad = {c for c in text.lower() if c in _KZ_ONLY_CHARS}
            if bad:
                _logger.warning(
                    "Mongolian input contains Kazakh-only characters %s; the model "
                    "was conditioned with [LANG_MN] and may produce "
                    "out-of-distribution audio.", sorted(bad),
                )

    def synthesize(
        self,
        text: str,
        lang: str = "mn",
        ref_audio_path: str | Path | None = None,
        ref_text: str | None = None,
        n_steps: int = 32,
        cfg_strength: float = 2.0,
        sway_sampling_coef: float | None = -1.0,
        speed: float = 1.0,
        target_duration_s: float | None = None,
        max_chars_per_chunk: int | None = DEFAULT_MAX_CHARS_PER_CHUNK,
        pause_s: float = DEFAULT_PAUSE_S,
        seed: int | None = None,
        cfg_interval: tuple[float, float] | None = None,
        method: str = "euler",
    ) -> np.ndarray:
        """Synthesize speech; returns a float32 waveform [T_samples].

        ``cfg_interval=(lo, hi)`` restricts guidance to the steps whose time
        lies in the interval and ``method`` picks the solver (``CFM.sample``).
        """
        lang, chunks, chunk_durs = self._prepare_synthesis(
            text, lang, ref_text, n_steps, cfg_strength, speed,
            target_duration_s, max_chars_per_chunk, pause_s,
        )
        waveforms = self._synthesize_chunks(
            chunks, lang, ref_audio_path, ref_text, speed, chunk_durs,
            _chunk_seeds(seed, len(chunks)),
            self._sampler(n_steps, cfg_strength, sway_sampling_coef, cfg_interval, method),
        )
        return concat_with_pause(waveforms, self.sample_rate, pause_s)

    def synthesize_mel(
        self,
        text: str,
        lang: str = "mn",
        ref_audio_path: str | Path | None = None,
        ref_text: str | None = None,
        n_steps: int = 32,
        cfg_strength: float = 2.0,
        sway_sampling_coef: float | None = -1.0,
        speed: float = 1.0,
        target_duration_s: float | None = None,
        seed: int | None = None,
        cfg_interval: tuple[float, float] | None = None,
        method: str = "euler",
    ) -> np.ndarray:
        """Generated log-mel [n_mels, T] for a single-segment text (no vocoder)."""
        lang, chunks, chunk_durs = self._prepare_synthesis(
            text, lang, ref_text, n_steps, cfg_strength, speed,
            target_duration_s, max_chars_per_chunk=None, pause_s=0.0,
        )
        plan = self._plan_chunks(chunks, lang, ref_audio_path, ref_text, speed, chunk_durs)
        mel, _ = self._solve_group(
            [0], plan, _chunk_seeds(seed, 1),
            self._sampler(n_steps, cfg_strength, sway_sampling_coef, cfg_interval, method))
        return mel[0, : plan.target_lens[0]].T.float().cpu().numpy()

    def synthesize_stream(
        self,
        text: str,
        lang: str = "mn",
        ref_audio_path: str | Path | None = None,
        ref_text: str | None = None,
        n_steps: int = 32,
        cfg_strength: float = 2.0,
        sway_sampling_coef: float | None = -1.0,
        speed: float = 1.0,
        target_duration_s: float | None = None,
        max_chars_per_chunk: int | None = DEFAULT_MAX_CHARS_PER_CHUNK,
        pause_s: float = DEFAULT_PAUSE_S,
        seed: int | None = None,
        cfg_interval: tuple[float, float] | None = None,
        method: str = "euler",
    ) -> Iterator[np.ndarray]:
        """Incremental synthesis: yields waveform pieces in playback order.

        The pieces (chunk waveforms and the pauses between them) joined equal
        :meth:`synthesize`: every chunk draws from its own seed either way, so
        only the order of float sums can differ. The first chunk is solved
        alone and fetched before any other group is launched (a solve is tens
        of thousands of kernel launches and the host is what bounds it, so
        queuing the rest first would delay the first audio by the whole text):
        time to first audio is one single-chunk solve. Each later group is
        solved when the consumer asks for the next piece it holds.
        """
        lang, chunks, chunk_durs = self._prepare_synthesis(
            text, lang, ref_text, n_steps, cfg_strength, speed,
            target_duration_s, max_chars_per_chunk, pause_s,
        )
        target_lens, pending = self._dispatch_chunk_groups(
            chunks, lang, ref_audio_path, ref_text, speed, chunk_durs,
            _chunk_seeds(seed, len(chunks)),
            self._sampler(n_steps, cfg_strength, sway_sampling_coef, cfg_interval, method),
            isolate_first=True,
        )
        pause = np.zeros(int(self.sample_rate * pause_s), dtype=np.float32)
        ready: dict[int, np.ndarray] = {}
        next_idx = 0
        for group, decoded in pending:  # ordered by first chunk index
            ready.update(self._fetch_rows(group, decoded, target_lens))
            while next_idx in ready:
                if next_idx and len(pause):
                    yield pause
                yield ready.pop(next_idx)
                next_idx += 1

    def _prepare_synthesis(
        self, text, lang, ref_text, n_steps, cfg_strength, speed,
        target_duration_s, max_chars_per_chunk, pause_s,
    ) -> tuple[str, list[str], list[float | None]]:
        """Validate, split into chunks, and share an explicit duration out."""
        lang = validate_language(lang)
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        if cfg_strength < 0:
            raise ValueError(f"cfg_strength must be >= 0, got {cfg_strength}")
        if speed <= 0:
            raise ValueError(f"speed must be > 0, got {speed}")
        if target_duration_s is not None and target_duration_s <= 0:
            raise ValueError(f"target_duration_s must be > 0, got {target_duration_s}")
        if max_chars_per_chunk is not None and max_chars_per_chunk < 0:
            raise ValueError(f"max_chars_per_chunk must be >= 0, got {max_chars_per_chunk}")
        if pause_s < 0:
            raise ValueError(f"pause_s must be >= 0, got {pause_s}")
        if not self.params_loaded:
            raise RuntimeError("load DiT parameters first (load_params or load_checkpoint)")

        self._warn_lang_contamination(text, lang)
        if ref_text:
            self._warn_lang_contamination(ref_text, lang)
        max_chars = max_chars_per_chunk or 0
        chunks = split_text_for_synthesis(text, max_chars) if max_chars > 0 else [text.strip()]
        chunks = [c for c in chunks if c]
        if not chunks:
            raise ValueError("text must not be empty")
        weights = [max(1, len(c.replace(" ", ""))) for c in chunks]
        total = sum(weights)
        chunk_durs: list[float | None] = [
            None if target_duration_s is None
            else target_duration_s * w / total if len(chunks) > 1 else target_duration_s
            for w in weights
        ]
        return lang, chunks, chunk_durs

    # Rows × bucket frames one solve may hold. Swept on an NVIDIA H100 80GB HBM3
    # at 700 W (chip_smoke.py, batch_knee phase: Base, bf16, 8 steps): a solo
    # row is bound by the host's launches, and the time per row falls from
    # 0.137 s (1 × 832 frames) to 0.049 s at 4 × 832 and 0.046 s at 8 × 832;
    # at 16 × 832 it is 0.043 s, and 1,600-frame rows behave alike (0.133,
    # 0.103 at 4, 0.097 at 8). Past 6,656 frames a doubling buys under 6% per
    # row and doubles the time every row of the group waits, so the budget
    # stops there: 8 rows of the default 832-frame bucket, 4 of 1,600.
    GROUP_FRAME_BUDGET = 6656

    @staticmethod
    def _pad_rows(n: int, row_multiple: int = 1) -> int:
        """Rows a group of ``n`` solves: a multiple of the data size under a mesh."""
        return -(-n // row_multiple) * row_multiple

    @classmethod
    def _length_groups(
        cls, target_lens: list[int], pad_to_multiple: int, max_batch: int,
        tolerance: float = 1.3, row_multiple: int = 1,
    ) -> list[list[int]]:
        """Group row indices by similar target length.

        One bucket for all rows pads every row to the longest: a single long
        text would tax the whole batch with attention over padding. Sorted
        greedy grouping bounds that waste, and a merge pass then joins
        neighbouring groups whenever rows × bucket shrinks. A group holds at
        most ``GROUP_FRAME_BUDGET // bucket`` rows (and ``max_batch``): short
        utterances batch widely, full-length chunks solve nearly alone. Under
        a mesh (``row_multiple``, the data size) the budget is per data rank
        and a cap is a multiple of the data size.
        """
        def bucket(g: list[int]) -> int:
            return -(-max(target_lens[i] for i in g) // pad_to_multiple) * pad_to_multiple

        def cap(b: int) -> int:
            rows = max(1, cls.GROUP_FRAME_BUDGET * row_multiple // b)
            if row_multiple > 1:
                rows = max(row_multiple, rows - rows % row_multiple)
            return min(max_batch, rows)

        def cost(g: list[int]) -> int:
            return cls._pad_rows(len(g), row_multiple) * bucket(g)

        order = sorted(range(len(target_lens)), key=lambda i: target_lens[i])
        groups: list[list[int]] = []
        cur: list[int] = []
        for idx in order:
            if not cur:
                cur = [idx]
                continue
            lo = target_lens[cur[0]]
            limit = max(lo * tolerance, lo + pad_to_multiple)
            if target_lens[idx] <= limit and len(cur) < cap(bucket(cur + [idx])):
                cur.append(idx)
            else:
                groups.append(cur)
                cur = [idx]
        if cur:
            groups.append(cur)

        changed = True
        while changed and len(groups) > 1:
            changed = False
            for i in range(len(groups) - 1):
                a, b = groups[i], groups[i + 1]
                if len(a) + len(b) > cap(bucket(a + b)):
                    continue
                if cost(a + b) < cost(a) + cost(b):
                    groups[i: i + 2] = [a + b]
                    changed = True
                    break
        return groups

    def synthesize_batch(
        self,
        texts: list[str],
        lang: str = "mn",
        n_steps: int = 32,
        cfg_strength: float = 2.0,
        sway_sampling_coef: float | None = -1.0,
        speed: float = 1.0,
        seed: int | None = None,
        max_batch: int = 16,
        seeds: list[int] | None = None,
        max_chars_per_chunk: int | None = DEFAULT_MAX_CHARS_PER_CHUNK,
        pause_s: float = DEFAULT_PAUSE_S,
        ref_audio_path: str | Path | None = None,
        ref_text: str | None = None,
        cfg_interval: tuple[float, float] | None = None,
        method: str = "euler",
    ) -> list[np.ndarray]:
        """Batched synthesis: few sampler calls for many utterances.

        Every text is split into chunks, all rows of all texts are
        length-grouped, each group rides one CFG solve and one lens-masked
        vocoder call, and each text's chunks are joined with ``pause_s`` of
        silence. ``ref_audio_path``/``ref_text`` clone one voice across the
        whole batch (the reference mel is loaded once).

        Determinism contract: text i's chunk c draws its noise from its own
        seed (``seeds[i] + c``, with ``seeds[i]`` defaulting to
        ``(seed or 0) + i``), whatever the batch, the grouping, the row's
        position and the bucket, so ``synthesize_batch(texts, seeds=[s, ...])[i]``
        matches ``synthesize(texts[i], seed=s)`` up to the order of float sums.
        """
        if not self.params_loaded:
            raise RuntimeError("load DiT parameters first (load_params or load_checkpoint)")
        lang = validate_language(lang)
        if not texts:
            return []
        if speed <= 0:
            raise ValueError(f"speed must be > 0, got {speed}")
        if seeds is not None and len(seeds) != len(texts):
            raise ValueError(
                f"seeds must have one entry per text: {len(seeds)} != {len(texts)}")
        if seeds is None:
            seeds = _chunk_seeds(seed, len(texts))

        max_chars = max_chars_per_chunk or 0
        chunk_texts: list[str] = []
        owner: list[int] = []
        row_seeds: list[int] = []
        for i, t in enumerate(texts):
            cs = split_text_for_synthesis(t, max_chars) if max_chars > 0 else [t.strip()]
            cs = [c for c in cs if c]
            if not cs:
                raise ValueError(f"texts[{i}] must not be empty")
            chunk_texts.extend(cs)
            owner.extend([i] * len(cs))
            row_seeds.extend(_chunk_seeds(seeds[i], len(cs)))

        if ref_text:
            self._warn_lang_contamination(ref_text, lang)
        chunk_wavs = self._synthesize_chunks(
            chunk_texts, lang, ref_audio_path, ref_text, speed, [None] * len(chunk_texts),
            row_seeds, self._sampler(n_steps, cfg_strength, sway_sampling_coef, cfg_interval,
                                     method),
            max_batch=max_batch, row_multiple=self._row_multiple,
        )
        return [
            concat_with_pause([w for w, o in zip(chunk_wavs, owner) if o == i],
                              self.sample_rate, pause_s)
            for i in range(len(texts))
        ]

    @staticmethod
    def _sampler(n_steps, cfg_strength, sway, cfg_interval, method) -> dict[str, Any]:
        """The solver's settings as ``CFM.sample`` keyword arguments."""
        if cfg_interval is not None:
            cfg_interval = (float(cfg_interval[0]), float(cfg_interval[1]))
        return dict(steps=n_steps, cfg_strength=cfg_strength, sway_sampling_coef=sway,
                    cfg_interval=cfg_interval, method=method)

    def _load_ref(self, ref_audio_path, ref_text, lang):
        """Reference audio → (mel [n_mels, T_ref] on the device, T_ref, ref ids)."""
        if ref_audio_path is None:
            return None, 0, []
        if not ref_text:
            _logger.warning(
                "ref_audio_path was provided without ref_text; duration will fall "
                "back to the ref-free estimate and the reference region will use "
                "filler text."
            )
        wav, _ = self.audio_processor.load_audio(ref_audio_path)
        wav = self.audio_processor.normalize_audio(wav)
        ref_mel = self.audio_processor.mel_spectrogram(wav)
        ref_ids = self.text_cleaner.text_to_sequence(ref_text, lang=lang) if ref_text is not None else []
        return ref_mel, ref_mel.shape[-1], ref_ids

    def _target_len(self, text, target_ids, target_duration_s, ref_len, ref_ids, speed) -> int:
        """Duration cascade: explicit → ref-ratio → calibrated table → chars·13/speed, min 50."""
        if target_duration_s is not None:
            return max(1, int(target_duration_s * self.sample_rate / self.hop_length))
        if ref_len > 0 and ref_ids:
            return max(50, int(ref_len * len(target_ids) / len(ref_ids) / speed))
        if self.duration_stats is not None:
            from oron_tts_tpu_torch.data.duration_stats import estimate_frames

            est = estimate_frames(target_ids, self.duration_stats, speed)
            if est is not None:
                return est
        chars = max(1, len(text.replace(" ", "")))
        return max(50, int(chars * 13 / speed))

    def _plan_chunks(self, chunks, lang, ref_audio_path, ref_text, speed, chunk_durs) -> "_Plan":
        """Load the reference once and size every chunk: what a solve needs besides seeds."""
        ref_mel, ref_len, ref_ids = self._load_ref(ref_audio_path, ref_text, lang)
        id_lists = [self.text_cleaner.text_to_sequence(c, lang=lang) for c in chunks]
        target_lens = [
            self._target_len(c, ids, dur, ref_len, ref_ids, speed)
            for c, ids, dur in zip(chunks, id_lists, chunk_durs)
        ]
        return _Plan(ref_mel, ref_len, ref_ids, id_lists, target_lens)

    @torch.no_grad()
    def _solve_group(self, group: list[int], plan: "_Plan", row_seeds: list[int],
                     sampler: dict[str, Any], row_multiple: int = 1,
                     ) -> tuple[torch.Tensor, slice | None]:
        """One solve for the chunks ``group``: (generated mels [rows, T_gen, n_mels], rows).

        ``len(group)`` rows padded to ``row_multiple`` are solved, at the
        group's bucket (a padding row is a short filler solve that nobody
        reads). All rows share the reference mel, so the generated region
        starts at the same frame on every row; ``T_gen`` is the longest target
        of the group. Under a mesh whose data size divides the rows, this rank
        solves its block of them and ``rows`` says which; otherwise ``rows``
        is None and every row is solved here.
        """
        ref_len = plan.ref_len
        totals = [ref_len + plan.target_lens[i] for i in group]
        bucket = self._bucket(max(totals))
        n_rows = self._pad_rows(len(group), row_multiple)
        text_arr = np.full((n_rows, bucket), -1, dtype=np.int64)
        for row, i in enumerate(group):
            if ref_len > 0:
                ids = (stretch_text_to_len(plan.ref_ids, ref_len)
                       + stretch_text_to_len(plan.id_lists[i], plan.target_lens[i]))
            else:
                ids = stretch_text_to_len(plan.id_lists[i], totals[row])
            text_arr[row, : totals[row]] = ids
        filler = min(bucket, max(ref_len + 1, 50))
        durations = totals + [filler] * (n_rows - len(group))
        seeds = [row_seeds[i] for i in group] + [0] * (n_rows - len(group))
        rows = None
        if self.mesh is not None and self.mesh.n_data > 1 and n_rows % self.mesh.n_data == 0:
            rows = pmesh.batch_rows(self.mesh, n_rows)
            text_arr, durations, seeds = text_arr[rows], durations[rows], seeds[rows]
        n_local = len(seeds)
        cond = torch.zeros((n_local, bucket, self.n_mels), dtype=torch.float32,
                           device=self.device)
        if plan.ref_mel is not None:
            cond[:, :ref_len] = plan.ref_mel.T.float()
        mel, _ = self.cfm.sample(
            cond, torch.from_numpy(text_arr).to(self.device), torch.tensor(durations),
            torch.tensor([ref_len] * n_local), seed=seeds, **sampler,
        )
        return mel[:, ref_len: max(totals)], rows

    def _fetch_rows(self, group, decoded: torch.Tensor, target_lens) -> dict[int, np.ndarray]:
        """A group's waveforms on the host, each cut to its own length, by chunk index."""
        host = decoded.cpu().numpy()
        return {i: host[row, : target_lens[i] * self.hop_length].astype(np.float32)
                for row, i in enumerate(group)}

    def _synthesize_chunks(
        self, chunks, lang, ref_audio_path, ref_text, speed, chunk_durs, row_seeds,
        sampler: dict[str, Any], max_batch: int = 16, row_multiple: int = 1,
    ) -> list[np.ndarray]:
        """Solve chunks in length-grouped batches; chunk i draws from ``row_seeds[i]``.

        Per-row seeds keep each chunk's output equal to its solo solve, so the
        grouping only saves time. Every group is launched before the first
        is fetched.
        """
        target_lens, pending = self._dispatch_chunk_groups(
            chunks, lang, ref_audio_path, ref_text, speed, chunk_durs, row_seeds, sampler,
            max_batch, row_multiple=row_multiple,
        )
        wavs: dict[int, np.ndarray] = {}
        for group, decoded in list(pending):
            wavs.update(self._fetch_rows(group, decoded, target_lens))
        return [wavs[i] for i in range(len(chunks))]

    def _dispatch_chunk_groups(
        self, chunks, lang, ref_audio_path, ref_text, speed, chunk_durs, row_seeds,
        sampler: dict[str, Any], max_batch: int = 16, isolate_first: bool = False,
        row_multiple: int = 1,
    ) -> tuple[list[int], Iterator[tuple[list[int], torch.Tensor]]]:
        """Plan the chunk groups now; solve and decode each when it is asked for.

        Returns (per-chunk target frame lengths, an iterator of (group chunk
        indices, decoded waveforms on the device)) ordered by first chunk
        index. The texts are cleaned and the reference is loaded here, so a bad
        request fails before any solve. The iterator launches a group's solve
        and vocoder call when it is advanced and does not wait for them:
        ``list()`` launches everything before the first fetch, a streaming
        consumer fetches each group before it launches the next.

        ``isolate_first`` puts chunk 0 in a group of its own, first.
        ``row_multiple`` pads every group's rows to a multiple of it (the data
        size under a mesh, where each data rank decodes its block of rows and
        the waveforms are gathered over the data group).
        """
        plan = self._plan_chunks(chunks, lang, ref_audio_path, ref_text, speed, chunk_durs)
        totals = [plan.ref_len + tl for tl in plan.target_lens]
        if isolate_first and len(chunks) > 1:
            rest = self._length_groups(totals[1:], self.pad_to_multiple, max_batch,
                                       row_multiple=row_multiple)
            groups = [[0]] + [[i + 1 for i in g] for g in rest]
        else:
            groups = self._length_groups(totals, self.pad_to_multiple, max_batch,
                                         row_multiple=row_multiple)
        groups.sort(key=min)

        def solve_all() -> Iterator[tuple[list[int], torch.Tensor]]:
            for group in groups:
                gen, rows = self._solve_group(group, plan, row_seeds, sampler, row_multiple)
                lens = [plan.target_lens[i] for i in group]
                lens += [lens[0]] * (self._pad_rows(len(group), row_multiple) - len(group))
                decoded = self._decode_mel_group(
                    gen.transpose(1, 2), lens if rows is None else lens[rows])
                if rows is not None:
                    decoded = pmesh.all_gather_rows(decoded, self.mesh.data_group)
                yield group, decoded

        return plan.target_lens, solve_all()


class _Plan(NamedTuple):
    """What `_plan_chunks` worked out: the shared reference and every chunk's size."""

    ref_mel: torch.Tensor | None
    ref_len: int
    ref_ids: list[int]
    id_lists: list[list[int]]
    target_lens: list[int]
