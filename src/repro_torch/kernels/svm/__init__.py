"""The svm kernel family."""
