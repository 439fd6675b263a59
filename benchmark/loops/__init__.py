"""Program loops: ``loops/<loop>.py`` gives ``Loop``, which drives the
program with one mix's inputs."""
