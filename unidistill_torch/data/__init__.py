"""Host-side (numpy) data preparation: the chunked layout's topology tables."""
