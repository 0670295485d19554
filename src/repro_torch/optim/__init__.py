"""The optimizer: AdamW with float32 or int8 moments (``adamw``), the
counterpart of the reference module of the same name."""
