"""DiT, CFM sampler, Vocos vocoder and the F5TTS facade."""
