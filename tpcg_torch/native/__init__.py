"""Host-side native helpers of the port (counterpart of ``tpcg/native``)."""
