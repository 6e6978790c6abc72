"""Model building blocks and the decoder LM (attention + MLP patterns)."""
