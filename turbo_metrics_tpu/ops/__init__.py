"""Device ops: the analog of the reference's PTX kernel + NPP layer."""
