"""The compressor pipeline."""
