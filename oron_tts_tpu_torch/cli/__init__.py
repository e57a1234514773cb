"""Command-line entry points of the PyTorch port: ``train``, ``infer``, ``serve``, ``export``,
data preparation (``prepare``, ``clean_local_cv``), the smoke harness
(``test_pipeline``), the tone-code eval (``make_tone_corpus``,
``eval_alignment``), vocoder training and its eval (``make_synthetic_speech``,
``train_vocoder``, ``eval_vocoder``), the denoiser's measurement
(``measure_denoiser``: host-only numpy, no device) and the benches
(``bench_serve_load``, ``bench_streaming``, ``bench_grad_accum``,
``bench_sampler_levers`` and ``bench_quantized`` among them). The benches take
the card unless given ``--device cpu`` (or ``--smoke``, a tiny CPU run where
they have one), and raise without a card.

``train``, ``infer`` and ``serve`` take ``--mesh DPxTP`` and then run as one
process per rank under ``torchrun``::

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m oron_tts_tpu_torch.cli.train --config configs/runpod.yaml --mesh 2x2
"""


def validate_quantize_mesh(parser, quantize: str | None, mesh: str | None) -> None:
    """One rule for ``infer`` and ``serve``: w8a16 runs on a single card.

    ``int8`` goes through the hand-written kernel, which has no sharded form;
    ``int8_dynamic`` is plain tensor code and shards like any matmul.
    """
    if quantize == "int8" and mesh:
        parser.error("--quantize int8 (the w8a16 kernel) is single-device; "
                     "use int8_dynamic with --mesh")


def mesh_or_exit(parser, spec: str, device: str | None):
    """``parallel.mesh.mesh_from_spec``, or a usage error that names ``torchrun``.

    A mesh whose size is not the world's is refused: it never falls back to
    one process.
    """
    from oron_tts_tpu_torch.parallel.mesh import mesh_from_spec

    try:
        return mesh_from_spec(spec, device=device)
    except ValueError as exc:
        parser.error(str(exc))
