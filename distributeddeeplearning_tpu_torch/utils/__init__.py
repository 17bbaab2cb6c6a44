"""Host-side utilities of the port (``utils/`` of the reference): the retry
policy, fault injection, input prefetch and the examples/sec tracker."""
