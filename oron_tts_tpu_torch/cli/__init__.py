"""Command-line entry points of the PyTorch port: ``train``, ``infer``, ``serve``, ``export``,
data preparation (``prepare``, ``clean_local_cv``), the smoke harness
(``test_pipeline``), the tone-code eval (``make_tone_corpus``,
``eval_alignment``), vocoder training and its eval (``make_synthetic_speech``,
``train_vocoder``, ``eval_vocoder``) and the benches (``bench_serve_load``,
``bench_streaming``, ``bench_grad_accum`` among them)."""

NOT_PORTED = (
    "{flag} is not ported to the PyTorch package yet (see ROADMAP.md, "
    "'Still to port')"
)


def validate_quantize_mesh(parser, quantize: str | None, mesh: str | None) -> None:
    """One rule for ``infer`` and ``serve``: w8a16 runs on a single card.

    ``int8`` goes through the hand-written kernel, which has no sharded form;
    ``int8_dynamic`` is plain tensor code. The port has no device mesh yet, so
    any ``--mesh`` is refused after this check, with a pointer to ROADMAP.md.
    """
    if quantize == "int8" and mesh:
        parser.error("--quantize int8 (the w8a16 kernel) is single-device; "
                     "use int8_dynamic with --mesh")
    if mesh:
        parser.error(NOT_PORTED.format(flag="--mesh") + ", section 1 item 5 (multi-GPU)")
