"""Probes of the hand-written kernels' design questions, run on the card
(``python -m leaxer_qwen3_tts_torch.tools.<probe>``)."""
