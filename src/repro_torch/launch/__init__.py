"""Command-line entry points (reference: ``repro/launch``)."""
