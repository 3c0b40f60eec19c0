"""The benchmark's own yardstick: traffic, reference, judge, ledger, trace
and the run loops. Nothing here is the program under test."""
