"""Host-side detection scoring (training comes with the QAT slice)."""
