"""The generic harness of fembench: discovery, the run loop, the profile
reduction, the roofline, the comparison."""
