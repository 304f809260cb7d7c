"""File-format helpers of the port (output naming, RRC parameter CSVs, the
AOS downlink frames and their CRC-16)."""
