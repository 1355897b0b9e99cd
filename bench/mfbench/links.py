"""The published link rate between the cards of one NVIDIA H100 host
(DGX H100 data sheet: NVLink 4, 900 GB/s a card, 450 GB/s each way),
frozen here so that no change to the program can move the yardstick."""

#: NVLink 4 between two H100 cards, bytes per second each way
NVLINK_BYTES_S = 450e9
