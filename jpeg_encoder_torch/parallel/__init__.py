"""Many-image and multi-device encodes: batches, streams, bands, datasets."""
