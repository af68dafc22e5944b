"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes of the model step and of the two attention kernels, computed from
shapes and each round's real lengths, never counted from the program."""
