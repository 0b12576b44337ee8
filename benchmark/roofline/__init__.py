"""Per layer, the names of its kernels and the operations and bytes its
algorithm needs, counted from the shapes; the card's peaks."""
