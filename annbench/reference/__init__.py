"""The plain reference (`ivfadc`) and the comparison that decides a
run's `correct` (`compare`)."""
