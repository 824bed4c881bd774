"""The frozen yardstick of the roofline metrics: the card's peaks, the K1
byte rule and each configuration's cycle bound, one file a configuration
(counts/<config>.py, `cycle(config, traffic) -> (bytes, operations)`)."""
