"""The part of the reference's scheduler the run store reads (own copies)."""
