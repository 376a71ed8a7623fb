"""The LM's optimizer: AdamW with global-norm clipping and the cosine
schedule (`adamw`)."""
