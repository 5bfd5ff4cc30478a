"""I/O layer: FITS core, PSRFITS reading, data-file domain model, synthesis."""
