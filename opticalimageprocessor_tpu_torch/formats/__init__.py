"""File-format helpers of the port (output naming, RRC parameter CSVs)."""
