"""Many-image encodes: batches of same-sized images on one device."""
